"""Scaled dot-product attention (the port of
``fengshen_tpu/ops/attention.py:28-45`` and ``:48-137``): the dense impl,
the block-sparse impl and the sequence-parallel impls.

The dense impl is plain torch, as the JAX package computes it outside
any Pallas kernel: fp32 scores and softmax, a boolean mask turned into a
-1e9 additive bias, dropout on the probabilities, and the probabilities
cast to ``v``'s dtype before the PV product. ``impl="sparse"`` with a
``sparse_layout`` (:76-97) sends CUDA tensors to kernel K4
(``ops/kernels/block_sparse_attention.py``), which skips absent blocks;
CPU tensors, and calls with a bias, a mask, dropout or segment ids, take
the dense path with the layout expanded into a mask (``np.kron``), as
the reference falls back, and count one ``dense_calls`` on K4's forward
entry. The two differ on a query block with no present key block: K4
gives zeros, the dense path the uniform mean of V. ``impl="flash"``
(:113-119) goes to ``ops/flash_attention.flash_attention`` with the mask
folded into the additive bias and the segment ids passed through: a
CUDA tensor launches kernel K1, which raises on a bias (a mask
included) by its rules; a CPU tensor takes the plain blockwise path,
bias and all, as the reference's fallback does. Attention dropout there
raises ``ValueError``, as it does in the reference. The impls
``"ring"``, ``"ulysses"`` and ``"sequence"`` (:127-136) go to
``ops/ulysses_attention.sequence_parallel_attention``, which on one
device is flash attention (kernel K1). Any other impl raises
``ValueError`` (:131).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _dense_attention(q, k, v, bias, dropout_rng, dropout_rate,
                     deterministic):
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=dropout_rng,
                          device=probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          dropout_rng: Optional[torch.Generator] = None,
                          dropout_rate: float = 0.0,
                          deterministic: bool = True,
                          impl: str = "dense",
                          sparse_layout=None,
                          sparse_block_size: int = 128,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``q [B, Sq, H, D]``, ``k/v [B, Sk, H, D]``; ``mask`` bool and
    ``bias`` additive, both broadcastable to ``[B, H, Sq, Sk]``;
    ``segment_ids`` int ``[B, S]`` (tokens attend within equal ids);
    ``sparse_layout`` a static numpy bool ``[Sq / blk, Sk / blk]`` block
    layout for ``impl="sparse"``. Dropout (``dropout_rate`` with
    ``deterministic=False``) draws from ``dropout_rng``, a
    ``torch.Generator`` on q's device. Returns ``[B, Sq, H, D]`` in
    ``v``'s dtype."""
    if impl == "sparse" and sparse_layout is not None:
        from fengshen_tpu_torch.ops.kernels import block_sparse_attention
        layout = np.asarray(sparse_layout, dtype=bool)
        blk = sparse_block_size
        plain_inputs = (bias is None and mask is None and
                        segment_ids is None and
                        (deterministic or dropout_rate == 0.0))
        if q.is_cuda and plain_inputs:
            return block_sparse_attention.block_sparse_attention(
                q, k, v, layout, blk)
        block_sparse_attention.FWD.dense_calls += 1
        expanded = torch.from_numpy(
            np.kron(layout, np.ones((blk, blk), dtype=bool))).to(q.device)
        mask = expanded[None, None] if mask is None else \
            (mask & expanded[None, None])
    if segment_ids is not None and impl in ("dense", "sparse"):
        seg_mask = (segment_ids[:, None, None, :] ==
                    segment_ids[:, None, :, None])
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        mask_bias = torch.where(mask, 0.0, -1e9).float()
        bias = mask_bias if bias is None else bias + mask_bias
    if impl in ("dense", "sparse"):
        return _dense_attention(q, k, v, bias, dropout_rng, dropout_rate,
                                deterministic)
    if impl == "flash":
        from fengshen_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, bias=bias, dropout_rng=dropout_rng,
                               dropout_rate=dropout_rate,
                               deterministic=deterministic,
                               segment_ids=segment_ids)
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
    raise ValueError(f"unknown attention impl {impl!r}")
