"""Counter-based random draws for sampled decoding, vectorised over lanes.

The reference draws with ``jax.random`` keys: one key per serving lane,
folded from the engine's base key and the request's seed at admission and
split in-graph every tick (``fengshen_tpu/serving/engine.py:441-449``,
``:1262-1280``). The port keeps that contract, not those bits: every
uniform is a pure function of

    (lane key, draw counter, stream path, element index)

where the lane key comes from ``(engine or call seed, request seed)``.
Nothing depends on batch composition, slot index, admission order, the
device or any global generator, so a lane served alone and a lane served
among others draw the same numbers.

The hash is 32-bit ``lowbias32`` (xor-shift-multiply) over int64 tensors
whose values stay in ``[0, 2**32)``; every product is split so that it
never leaves int64, and the same functions run on Python ints (for host
key derivation) and on CPU or CUDA tensors with identical results. A
``[B, V]`` draw costs a few elementwise kernels over ``B x V`` elements.
Categorical draws are Gumbel-max (``argmax(logits + Gumbel noise)``), as
``jax.random.categorical`` draws them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
#: separates the second key word's chain from the first's
_KEY1_SALT = 0x632BE5AB

IntOrTensor = Union[int, torch.Tensor]


def _mul32(x: IntOrTensor, c: int) -> IntOrTensor:
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` without leaving
    int64: ``c`` is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: IntOrTensor) -> IntOrTensor:
    """lowbias32: a bijection of ``[0, 2**32)`` with low bias."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _absorb(h: IntOrTensor, word: IntOrTensor) -> IntOrTensor:
    """Fold one 32-bit word into the running hash ``h``."""
    return _mix32(((h ^ word) + _GOLDEN) & _M32)


def key_from_seed(seed: int) -> Tuple[int, int]:
    """The two 32-bit key words of an integer seed (any sign or width)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    lo, hi = seed & _M32, seed >> 32
    return (_absorb(_absorb(0, lo), hi),
            _absorb(_absorb(_KEY1_SALT, lo), hi))


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """A new key from ``key`` and an integer (``jax.random.fold_in``)."""
    data = int(data) & 0xFFFFFFFFFFFFFFFF
    lo, hi = data & _M32, data >> 32
    return (_absorb(_absorb(key[0], lo), hi),
            _absorb(_absorb(key[1] ^ _KEY1_SALT, lo), hi))


def lane_key(base_seed: int, request_seed: int) -> Tuple[int, int]:
    """A serving lane's key: the engine's seed with the request's folded
    in (the reference's ``fold_in(PRNGKey(seed), request.seed)``)."""
    return fold_in(key_from_seed(base_seed), request_seed)


class Draws(NamedTuple):
    """Where a batch of draws comes from: one key per row (``keys
    [B, 2]`` int64, 32-bit words), the row's draw counter (``counter
    [B]`` int64) and a stream path (a 32-bit word that :meth:`sub`
    extends, the counterpart of splitting a key)."""

    keys: torch.Tensor
    counter: torch.Tensor
    stream: int = 0

    @classmethod
    def for_rows(cls, seed: int, rows: int, counter: int = 0,
                 device=None) -> "Draws":
        """Row ``i`` of an offline batch draws as request ``i`` under the
        call's ``seed``."""
        base = key_from_seed(seed)
        keys = torch.tensor([fold_in(base, i) for i in range(rows)],
                            dtype=torch.long, device=device)
        return cls(keys.reshape(rows, 2),
                   torch.full((rows,), counter, dtype=torch.long,
                              device=device))

    def sub(self, stream: int) -> "Draws":
        """An independent stream under the same keys and counter."""
        return self._replace(stream=_absorb(self.stream, stream & _M32))

    def at(self, counter: IntOrTensor) -> "Draws":
        """The same keys at another draw counter (an int or ``[B]``)."""
        counter = torch.as_tensor(counter, dtype=torch.long,
                                  device=self.keys.device)
        return self._replace(counter=counter.expand(self.keys.shape[0]))

    def _row_hash(self) -> torch.Tensor:
        """``[B, 1]``: each row's key, counter and stream folded."""
        h = _absorb(self.keys[:, 0], self.keys[:, 1])
        h = _absorb(h, self.counter & _M32)
        h = _absorb(h, (self.counter >> 32) & _M32)
        return _absorb(h, self.stream)[:, None]

    def bits(self, n: int) -> torch.Tensor:
        """``[B, n]`` independent 32-bit words (int64 in [0, 2**32))."""
        idx = torch.arange(n, dtype=torch.long, device=self.keys.device)
        return _mix32(_absorb(self._row_hash(), idx[None]))

    def uniform(self, n: int) -> torch.Tensor:
        """``[B, n]`` fp32 uniforms in (0, 1) (:func:`unit_interval`)."""
        return unit_interval(self.bits(n))


def unit_interval(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words to fp32 uniforms strictly inside (0, 1): the top 23
    bits, centred in their cell. Every value is exact in fp32; with 24
    bits the top cell's centre, 2**24 - 0.5, would round up to exactly
    1.0, whose Gumbel noise is infinite."""
    return ((bits >> 9).float() + 0.5) * 2.0 ** -23


def categorical(draws: Draws, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` (``[B, V]``), by
    Gumbel-max over the row's ``V`` uniforms. Returns ``[B]`` int64."""
    u = draws.uniform(logits.shape[-1])
    return (logits.float() - torch.log(-torch.log(u))).argmax(-1)
