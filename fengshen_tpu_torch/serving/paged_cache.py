"""Paged KV pool for the serving engine: the port of
``fengshen_tpu/serving/paged_cache.py``.

- device side: per layer a shared ``[num_blocks, block_size, KVH, D]``
  pool, a ``[num_slots, max_blocks_per_slot]`` int32 ``block_table`` and
  a ``[num_slots]`` cursor. The attention layer scatters each step at
  ``table[lane, p // bs] * bs + p % bs``; the decode kernel reads the
  pool through the table;
- host side: :class:`BlockAllocator`, a plain free list on the
  scheduler thread;
- block 0 is the NULL block: never allocated, parked on by every free
  lane's table row, so stray writes land there and are never read back
  unmasked;
- an int8 pool (``kv_dtype="int8"``) stores K/V as int8 with one fp32
  absmax scale per (token, head) beside them (``ops/int8_matmul``);
  prefilled lanes are quantized as they are assigned, and the decode
  seam dequantizes inside the attention read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from fengshen_tpu_torch.models.llama.modeling_llama import (KVCache,
                                                            torch_dtype)
from fengshen_tpu_torch.ops.int8_matmul import quantize_kv

#: the reserved garbage block free lanes point at (never allocated)
NULL_BLOCK = 0


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """ceil(n_tokens / block_size): the admission charge for a request."""
    return -(-int(n_tokens) // int(block_size))


class BlockAllocator:
    """Host-side free list over the paged KV pool (a copy of the
    reference's ``BlockAllocator``).

    Lowest-id-first from a fresh pool, then LIFO reuse. Double-free and
    foreign-id frees raise instead of silently corrupting the pool.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (block {NULL_BLOCK} is the reserved "
                f"null block), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self._used: set[int] = set()

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (the null block is not one)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids, or None when the pool can't serve them all —
        the caller requeues the request (admission backpressure)."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._used.update(blocks)
        return blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise ValueError(
                    f"free of block {b} that is not allocated "
                    "(double-free or foreign id)")
            self._used.remove(b)
            self._free.append(b)


def init_pool_cache(model, num_slots: int, *, layout: str = "slot",
                    kv_dtype: str = "fp32", num_blocks: int = 0,
                    block_size: int = 0,
                    max_blocks_per_slot: int = 0) -> KVCache:
    """Zeros KV pool for the engine, the one constructor for the four
    (layout, dtype) pairs (``paged_cache.py:139``). ``kv_dtype`` "fp32"
    names the unquantized pool in the compute dtype, as in the
    reference; "int8" gives int8 values and fp32 scales of the pool's
    leading shape."""
    if layout not in ("slot", "paged"):
        raise ValueError(f"unknown kv layout {layout!r}")
    if kv_dtype not in ("fp32", "int8"):
        raise ValueError(f"unknown kv dtype {kv_dtype!r}")
    cfg = model.config
    dev = model.device
    if layout == "slot" and kv_dtype == "fp32":
        from fengshen_tpu_torch.serving.cache import init_slot_cache
        return init_slot_cache(model, num_slots)
    n_kv, n = cfg.num_key_value_heads, cfg.num_hidden_layers
    lead = ((num_slots, cfg.max_position_embeddings) if layout == "slot"
            else (num_blocks, block_size))
    int8 = kv_dtype == "int8"
    dt = torch.int8 if int8 else torch_dtype(cfg.dtype)

    def zeros(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(n)]

    values = lead + (n_kv, cfg.head_dim)
    table = None if layout == "slot" else torch.zeros(
        (num_slots, max_blocks_per_slot), dtype=torch.int32, device=dev)
    return KVCache(
        zeros(values, dt), zeros(values, dt),
        torch.zeros(num_slots, dtype=torch.long, device=dev), table,
        key_scales=zeros(lead + (n_kv,), torch.float32) if int8 else None,
        value_scales=zeros(lead + (n_kv,), torch.float32) if int8 else None)


def _triples(pool: KVCache, primed: KVCache):
    """(values, scales, primed lane) for each K and V tensor of each
    layer; scales is None for an unquantized pool."""
    scales = (pool.key_scales + pool.value_scales if pool.quantized
              else [None] * (2 * len(pool.keys)))
    return zip(pool.keys + pool.values, scales, primed.keys + primed.values)


def assign_slot_quantized(pool: KVCache, primed: KVCache,
                          slot: int) -> None:
    """int8 flavor of ``cache.assign_slot`` (``paged_cache.py:182``):
    quantize the primed lane (the direct ``_prefill_cache`` output, in
    the compute dtype) per (token, head) while copying it into int8
    lane ``slot``, scales beside it."""
    for values, scales, src in _triples(pool, primed):
        q, scale = quantize_kv(src[0])
        values[slot].copy_(q)
        scales[slot].copy_(scale)
    pool.index[slot] = int(primed.index)


def assign_paged(pool: KVCache, primed: KVCache, slot: int,
                 blocks: Sequence[int]) -> None:
    """Copy a batch-1 primed lockstep cache into the lane's ``blocks``
    (from the host allocator) and point lane ``slot``'s table row at
    them, padded with the null block.

    The reference copies the whole virtual lane and lets the padding
    entries clobber the null block; copying only the lane's own blocks
    writes the same values everywhere a read can see. An int8 pool
    quantizes on the way in (``paged_cache.py:214-260``): the scales are
    per (token, head), so quantizing the lane's own tokens gives the
    reference's values and scales."""
    block_size = pool.keys[0].shape[1]
    n_tok = len(blocks) * block_size
    ids = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=pool.keys[0].device)
    for values, scales, src in _triples(pool, primed):
        lane = src[0, :n_tok]
        if scales is not None:
            lane, scale = quantize_kv(lane)
            scales[ids] = scale.reshape(len(blocks), block_size,
                                        *scale.shape[1:])
        values[ids] = lane.reshape(len(blocks), block_size,
                                   *lane.shape[1:]).to(values.dtype)
    row = torch.zeros(pool.block_table.shape[1], dtype=torch.int32)
    row[:len(blocks)] = torch.as_tensor(list(blocks), dtype=torch.int32)
    pool.block_table[slot] = row.to(pool.block_table.device)
    pool.index[slot] = int(primed.index)
