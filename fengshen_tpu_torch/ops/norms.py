"""RMSNorm and LayerNorm (the port of ``fengshen_tpu/ops/norms.py:19``
and ``:42``).

Statistics are computed in fp32 whatever the activation dtype, the
parameters are fp32, and the result is cast back to the input's dtype,
as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Root-mean-square norm; the parameter is ``weight`` (the JAX
    package's ``scale``; see ``models/llama/convert.py``)."""

    def __init__(self, features: int, epsilon: float = 1e-8,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (y * self.weight).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm with fp32 statistics (:42): ``weight`` is the
    reference's ``scale``, ``bias`` its ``bias`` (the reference's
    ``use_scale`` and ``use_bias`` switches are on in every ported
    family)."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        centered = x32 - mean
        var = centered.square().mean(-1, keepdim=True)
        y = centered * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (y * self.weight + self.bias).to(x.dtype)
