"""RMSNorm (the port of ``fengshen_tpu/ops/norms.py:19``).

Statistics are computed in fp32 whatever the activation dtype, and the
scale parameter is fp32, as in the reference.
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
