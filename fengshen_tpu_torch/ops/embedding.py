"""Token embedding lookup (the single-device form of
``fengshen_tpu/ops/embedding.py:64 embed_lookup``)."""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with out-of-range and negative ids giving zero rows,
    as the reference's take path does."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    out = table[ids.clamp(0, n - 1)]
    return out * valid[..., None].to(table.dtype)
