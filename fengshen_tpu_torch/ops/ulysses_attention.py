"""Sequence-parallel attention with scheme selection: the one-device
part of ``fengshen_tpu/ops/ulysses_attention.py``.

:func:`sequence_parallel_attention` (:84) picks Ulysses or ring by the
``sequence`` degree and the head count, then runs the scheme through
``ops/ring_attention.sequence_sharded_call``, which on one device is
flash attention (kernel K1 on a card).
"""

from __future__ import annotations

from typing import Optional

import torch

from fengshen_tpu_torch.ops.ring_attention import sequence_sharded_call


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                segment_ids: Optional[torch.Tensor] = None,
                                mesh=None, causal: bool = True,
                                prefer: str = "auto") -> torch.Tensor:
    """Context-parallel attention. ``prefer``: ``"auto"`` (Ulysses when
    the head count divides the sequence degree, ring otherwise),
    ``"ring"`` or ``"ulysses"``. ``q/k/v [B, S, H, D]``."""
    if prefer not in ("auto", "ring", "ulysses"):
        raise ValueError(f"unknown prefer={prefer!r}")
    # on one device both schemes are the same flash call; the choice
    # only matters once a sequence axis shards the tokens
    return sequence_sharded_call(None, q, k, v, segment_ids=segment_ids,
                                 mesh=mesh, causal=causal)
