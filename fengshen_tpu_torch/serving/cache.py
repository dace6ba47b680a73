"""Slot-pool KV cache: the port of ``fengshen_tpu/serving/cache.py``.

``num_slots`` preallocated ``[max_len]`` lanes per layer and a ``[num_slots]``
cursor, so one decode forward serves every in-flight request at its own
position (the attention layer's vector-index path). The pool is a
:class:`KVCache` and these helpers update it IN PLACE.
"""

from __future__ import annotations

import torch

from fengshen_tpu_torch.models.llama.modeling_llama import (KVCache,
                                                            torch_dtype)


def init_slot_cache(model, num_slots: int) -> KVCache:
    """Zeros pool of ``num_slots`` lanes of ``max_position_embeddings``
    positions, in the model's compute dtype, with a vector cursor."""
    cfg = model.config
    pool = KVCache.zeros(cfg, num_slots, cfg.max_position_embeddings,
                         device=model.device, dtype=torch_dtype(cfg.dtype))
    pool.index = torch.zeros(num_slots, dtype=torch.long,
                             device=model.device)
    return pool


def assign_slot(pool: KVCache, primed: KVCache, slot: int) -> None:
    """Copy a batch-1 primed lockstep cache (the direct output of
    ``utils.generate._prefill_cache``) into lane ``slot``. The full lane
    is overwritten, so stale K/V from the evicted request cannot leak.
    Scales travel with their values when both caches carry them (the
    reference maps this copy over every leaf of the pool's pytree); an
    int8 pool fed an unquantized lane goes through
    ``paged_cache.assign_slot_quantized``."""
    if pool.quantized != primed.quantized:
        raise ValueError("assign_slot copies like into like; quantize an "
                         "fp lane into an int8 pool with "
                         "assign_slot_quantized")
    pairs = list(zip(pool.keys + pool.values, primed.keys + primed.values))
    if pool.quantized:
        pairs += zip(pool.key_scales + pool.value_scales,
                     primed.key_scales + primed.value_scales)
    for dst, src in pairs:
        dst[slot].copy_(src[0])
    pool.index[slot] = int(primed.index)


def rollback_slots(cache: KVCache, delta: torch.Tensor) -> None:
    """Lower each lane's cursor by its own ``delta`` (``[num_slots]``),
    the per-lane ``utils.generate._rollback_cache`` (``cache.py:64``).
    The speculative tick advances every lane by gamma+1 and each lane
    rolls back its rejected tail: entries past the cursor are masked and
    later overwritten in place."""
    cache.index = cache.index - delta


def reset_free_slots(cache: KVCache, active: torch.Tensor) -> None:
    """Park inactive lanes (``active`` is a ``[num_slots]`` bool tensor):
    their cursor goes to 0 and, on a paged pool, their block-table row
    to the null block, so their writes can never land in blocks that
    now belong to another lane."""
    cache.index = torch.where(active, cache.index, 0)
    if cache.block_table is not None:
        cache.block_table.masked_fill_(~active[:, None], 0)
