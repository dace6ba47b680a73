"""Scaled dot-product attention (the port of
``fengshen_tpu/ops/attention.py:28-45`` and ``:48``): the dense impl and
the sequence-parallel impls.

The dense impl is plain torch, as the JAX package computes it outside
any Pallas kernel: fp32 scores and softmax, a boolean mask turned into a
-1e9 additive bias, and the probabilities cast to ``v``'s dtype before
the PV product. The impls ``"ring"``, ``"ulysses"`` and ``"sequence"``
(:127-136) go to ``ops/ulysses_attention.sequence_parallel_attention``,
which on one device is flash attention (kernel K1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "dense",
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``q [B, Sq, H, D]``, ``k/v [B, Sk, H, D]``; ``mask`` bool and
    ``bias`` additive, both broadcastable to ``[B, H, Sq, Sk]``;
    ``segment_ids`` int ``[B, S]`` (tokens attend within equal ids).
    Returns ``[B, Sq, H, D]`` in ``v``'s dtype."""
    if segment_ids is not None and impl == "dense":
        seg_mask = (segment_ids[:, None, None, :] ==
                    segment_ids[:, None, :, None])
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        mask_bias = torch.where(mask, 0.0, -1e9).float()
        bias = mask_bias if bias is None else bias + mask_bias
    if impl in ("ring", "ulysses", "sequence"):
        if bias is not None:
            raise ValueError(f"impl={impl!r} supports causal/segment "
                             "masking only; express other patterns via "
                             "impl='dense'")
        from fengshen_tpu_torch.ops.ulysses_attention import (
            sequence_parallel_attention)
        prefer = {"ring": "ring", "ulysses": "ulysses",
                  "sequence": "auto"}[impl]
        return sequence_parallel_attention(q, k, v, segment_ids=segment_ids,
                                           causal=True, prefer=prefer)
    if impl != "dense":
        raise NotImplementedError(
            f"attention impl {impl!r} is not yet ported (dense, ring, "
            "ulysses and sequence are)")
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
