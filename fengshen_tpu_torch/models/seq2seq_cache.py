"""The decoder cache of the encoder-decoder families (T5, BART,
Pegasus): the port's counterpart of the flax ``"cache"`` collection the
reference's ``decode_logits(..., init_cache=True)`` mutates
(``fengshen_tpu/models/t5/modeling_t5.py:102-119``, ``:177-204``;
``fengshen_tpu/models/bart/modeling_bart.py:128-142``, ``:171-200``).

Per decoder layer it holds the self-attention K/V, ``[N, L, H, D]`` in
the compute dtype, written at the cursor :attr:`Seq2SeqCache.index`,
and the cross-attention K/V, projected from the encoder output once on
the priming call and read back on every later step
(``cross_from_cache``). A layer attends over the filled prefix
``[0, index + S)`` only: the reference attends over all ``L`` slots
with the empty ones masked to -1e9, whose probabilities are exactly 0,
so the two agree. ``L`` is the caller's (``utils/generate.py`` sizes
it to the decode); a write past it raises where the reference's
``dynamic_update_slice`` would clamp. A beam reorder
(:meth:`Seq2SeqCache.reorder`) gathers the self-attention rows alone:
the cross K/V of a batch row's beams are equal.
"""

from __future__ import annotations

from typing import Optional

import torch


class Seq2SeqCache:
    def __init__(self, keys: list, values: list):
        self.keys, self.values = keys, values
        self.cross_keys: list = [None] * len(keys)
        self.cross_values: list = [None] * len(keys)
        #: the slot the next decoded position is written at
        self.index = 0

    @classmethod
    def zeros(cls, n_layers: int, rows: int, length: int, heads: int,
              head_dim: int, device=None,
              dtype: torch.dtype = torch.float32) -> "Seq2SeqCache":
        def make():
            return [torch.zeros(rows, length, heads, head_dim, dtype=dtype,
                                device=device) for _ in range(n_layers)]
        return cls(make(), make())

    @property
    def length(self) -> int:
        return self.keys[0].shape[1]

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """Write ``k``/``v`` ``[N, S, H, D]`` of layer ``layer`` at the
        cursor; return the filled prefix ``[N, index + S, H, D]`` of
        each. The cursor moves in :meth:`advance`, once per forward."""
        seq = k.shape[1]
        end = self.index + seq
        if end > self.length:
            raise ValueError(f"the decoder cache holds {self.length} "
                             f"positions; writing {seq} at {self.index} "
                             "overflows it")
        ck, cv = self.keys[layer], self.values[layer]
        ck[:, self.index:end] = k.to(ck.dtype)
        cv[:, self.index:end] = v.to(cv.dtype)
        return ck[:, :end], cv[:, :end]

    def advance(self, seq: int) -> None:
        self.index += seq

    def cross(self, layer: int) -> Optional[tuple]:
        """The layer's cross-attention K/V, or None before priming."""
        if self.cross_keys[layer] is None:
            return None
        return self.cross_keys[layer], self.cross_values[layer]

    def set_cross(self, layer: int, k: torch.Tensor,
                  v: torch.Tensor) -> None:
        self.cross_keys[layer], self.cross_values[layer] = k, v

    def reorder(self, rows: torch.Tensor) -> None:
        """Row ``i`` of every self-attention entry becomes row
        ``rows[i]`` (the filled prefix; in place)."""
        n = self.index
        for cache in (self.keys, self.values):
            for t in cache:
                t[:, :n] = t[rows, :n]
