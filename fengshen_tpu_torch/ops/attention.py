"""Dense scaled dot-product attention (the port of
``fengshen_tpu/ops/attention.py:28-45`` and ``:48``, dense impl only).

Plain torch, as the JAX package computes it outside any Pallas kernel:
fp32 scores and softmax, a boolean mask turned into a -1e9 additive
bias, and the probabilities cast to ``v``'s dtype before the PV product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "dense") -> torch.Tensor:
    """``q [B, Sq, H, D]``, ``k/v [B, Sk, H, D]``; ``mask`` bool and
    ``bias`` additive, both broadcastable to ``[B, H, Sq, Sk]``. Returns
    ``[B, Sq, H, D]`` in ``v``'s dtype."""
    if impl != "dense":
        raise NotImplementedError(
            f"attention impl {impl!r} is not yet ported (dense only)")
    if mask is not None:
        mask_bias = torch.where(mask, 0.0, -1e9).float()
        bias = mask_bias if bias is None else bias + mask_bias
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
