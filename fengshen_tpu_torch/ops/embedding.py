"""Token embedding lookup: the single-device form of
``fengshen_tpu/ops/embedding.py`` (``embed_lookup``, :64, and
``VocabParallelEmbed``, :96).

On one device the vocab is not sharded, so the reference's lookup is
its plain ``take`` branch: out-of-range and negative ids give zero
rows. :class:`VocabParallelEmbed` keeps the table in ``param_dtype`` as
``weight [V, H]`` (the reference's ``embedding``) and returns rows in
the compute dtype the caller names, as ``nn.Embed(dtype=...)`` does.
"""

from __future__ import annotations

import torch
from torch import nn


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with out-of-range and negative ids giving zero rows,
    as the reference's take path does."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    out = table[ids.clamp(0, n - 1)]
    return out * valid[..., None].to(table.dtype)


class VocabParallelEmbed(nn.Module):
    """The one-device ``VocabParallelEmbed``: ``weight [V, H]`` in
    ``param_dtype``; :meth:`forward` looks rows up with
    :func:`embed_lookup` and casts them to the compute ``dtype`` (the
    reference casts the table first: the same values)."""

    def __init__(self, num_embeddings: int, features: int,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=param_dtype, device=device))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return embed_lookup(self.weight, ids).to(dtype)
