"""Memory-efficient exact attention: the port of
``fengshen_tpu/ops/flash_attention.py``.

- :func:`blockwise_attention` is the plain version, a copy of the
  reference's ``blockwise_attention`` (:28): online softmax over k/v
  blocks, causal masking with queries right-aligned to keys, segment
  ids, masked scores at -1e30. It runs the CPU tests, is differentiable
  by autograd, and is what the card holds kernel K1 against.
- :func:`flash_attention` is the dispatch (:140). A CUDA tensor goes to
  kernel K1 (``ops/kernels/flash_attention.py``), which takes GQA
  natively and raises on anything outside its rules (a bias among
  them); a CPU tensor takes the plain version,
  :func:`plain_flash_attention` (K/V heads repeated for GQA as the
  reference's fallback does), which is also what the kernels' registered
  plain versions call.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False, block_size: int = 512,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Online-softmax attention. ``q [B, Sq, H, D]``, ``k/v [B, Sk, H, D]``,
    ``bias`` broadcastable to ``[B, H, Sq, Sk]``; segment ids int
    ``[B, S]`` (tokens attend only within equal ids). Returns
    ``[B, Sq, H, D]`` in q's dtype. Scores are fp32; the probabilities
    are rounded to v's dtype before the PV product, as in the
    reference."""
    batch, q_len, num_heads, head_dim = q.shape
    k_len = k.shape[1]
    blk = min(block_size, k_len)
    pad = (blk - k_len % blk) % blk
    if pad:  # pad k/v to a block multiple; padding is masked by position
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if bias is not None:
        bias = bias.float().expand(*bias.shape[:-2], q_len, k_len)
        if pad:
            bias = torch.nn.functional.pad(bias, (0, pad), value=_NEG_INF)
    if kv_segment_ids is not None and kv_segment_ids.shape[1] < k_len + pad:
        kv_segment_ids = torch.nn.functional.pad(
            kv_segment_ids, (0, k_len + pad - kv_segment_ids.shape[1]),
            value=-1)                   # -1 never equals a real segment id
    padded_len = k_len + pad
    n_blocks = padded_len // blk
    # the reference's fp32 1/sqrt(D), as a Python float of that value
    scale = (1.0 / torch.sqrt(torch.tensor(float(head_dim)))).item()
    # global positions; q is right-aligned with k (Sq suffix of Sk)
    q_pos = torch.arange(k_len - q_len, k_len, device=q.device)
    qf = q.float()

    acc = torch.zeros(batch, q_len, num_heads, head_dim,
                      dtype=torch.float32, device=q.device)
    row_max = torch.full((batch, num_heads, q_len), _NEG_INF,
                         dtype=torch.float32, device=q.device)
    row_sum = torch.zeros(batch, num_heads, q_len, dtype=torch.float32,
                          device=q.device)
    for bi in range(n_blocks):
        sl = slice(bi * blk, (bi + 1) * blk)
        k_blk, v_blk = k[:, sl], v[:, sl]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if bias is not None:
            scores = scores + bias[..., sl]
        k_pos = bi * blk + torch.arange(blk, device=q.device)
        if causal:
            allowed = (k_pos[None, :] <= q_pos[:, None]) & \
                (k_pos[None, :] < k_len)
        else:
            allowed = (k_pos[None, :] < k_len).expand(q_len, blk)
        allowed = allowed[None, None].expand(batch, 1, q_len, blk)
        if kv_segment_ids is not None:
            same = q_segment_ids[:, :, None] == \
                kv_segment_ids[:, None, sl]                 # [B, Sq, blk]
            allowed = allowed & same[:, None]
        scores = scores.masked_fill(~allowed, _NEG_INF)
        blk_max = scores.amax(dim=-1)                       # [B, H, Sq]
        new_max = torch.maximum(row_max, blk_max)
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(scores - new_max[..., None])
        # fully masked blocks contribute nothing (probs underflow to 0 at
        # exp(_NEG_INF - max))
        row_sum = row_sum * correction + probs.sum(dim=-1)
        blk_out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v_blk.dtype),
                               v_blk).float()
        acc = acc * correction.transpose(1, 2)[..., None] + blk_out
        row_max = new_max
    out = acc / torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = False, block_size: int = 512,
                          q_segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K1's plain version: :func:`blockwise_attention` with the K/V heads
    repeated for GQA, as the reference's fallback does. ``k/v`` are
    ``[B, Sk, KVH, D]`` with ``H % KVH == 0``."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return blockwise_attention(q, k, v, bias=bias, causal=causal,
                               block_size=block_size,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    dropout_rng=None, dropout_rate: float = 0.0,
                    deterministic: bool = True, block_size: int = 512,
                    causal: bool = False, segment_ids=None) -> torch.Tensor:
    """Flash attention with kernel dispatch. ``q [B, Sq, H, D]``,
    ``k/v [B, Sk, KVH, D]`` with ``H % KVH == 0``.

    ``segment_ids``: int ``[B, S]`` (or a ``(q_ids, kv_ids)`` pair):
    tokens attend only within equal ids, so a padded batch's
    attention_mask maps directly (pads become segment 0). Attention
    dropout is refused, as in the reference (:159-161)."""
    del dropout_rng
    if not deterministic and dropout_rate > 0.0:
        raise ValueError("flash attention path does not support attention "
                         "dropout; use impl='dense'")
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32)
        kv_seg = kv_seg.to(torch.int32)
    from fengshen_tpu_torch.ops.kernels import kernel_choice
    if kernel_choice("flash_attention_fwd", q) == "cuda":
        if bias is not None:
            raise ValueError("flash attention kernel: an additive bias is "
                             "outside the kernel's rules (use causal and "
                             "segment ids, or impl='dense')")
        from fengshen_tpu_torch.ops.kernels.flash_attention import (
            kernel_flash_attention)
        return kernel_flash_attention(q, k, v, q_seg, kv_seg, causal)
    return plain_flash_attention(q, k, v, bias=bias, causal=causal,
                                 block_size=block_size, q_segment_ids=q_seg,
                                 kv_segment_ids=kv_seg)
