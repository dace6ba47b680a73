"""Dropout keyed by integer seeds: the port's counterpart of flax's
``nn.Dropout`` over the ``"dropout"`` rng stream.

The reference folds the step into its key (``fengshen_tpu/trainer/
trainer.py:334``) and every dropout site takes its own key from that.
The port's step carries a host ``torch.Generator`` (the Trainer seeds
it from ``--seed`` and the step, :func:`step_generator`); a model draws
one integer seed per dropout site from it, in order
(:func:`site_seeds`), and each site draws its mask on the tensor's
device from a generator of its own seed. A layer under gradient
checkpointing receives its seeds as arguments, so the recompute in the
backward draws the same masks. The masks cannot match the reference's
bits; they repeat for the same seed and step.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, micro: int = 0) -> torch.Generator:
    """The host generator of one training step's dropout (micro-batch
    ``micro`` of it): seeded from ``(seed, step, micro)``, as the
    reference folds the step and the micro-batch into its key."""
    mixed = _splitmix64(_splitmix64(_splitmix64(int(seed)) ^ int(step))
                        ^ int(micro))
    return torch.Generator().manual_seed(mixed >> 1)


def site_seeds(generator: Optional[torch.Generator], n: int) -> list:
    """``n`` integer seeds drawn from ``generator`` (None: ``[None] *
    n``, no dropout)."""
    if generator is None:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def forward_seeds(dropout_rng: Optional[torch.Generator], n_layers: int,
                  sites: int, active: bool) -> tuple:
    """``(embedding seed, [a tuple of ``sites`` seeds per layer])`` for
    one forward of a layer stack, drawn in that order from
    ``dropout_rng``; Nones when not ``active`` (deterministic, or every
    rate 0). An active forward without a generator raises, as flax does
    without a ``"dropout"`` rng."""
    if not active:
        return None, [None] * n_layers
    if dropout_rng is None:
        raise ValueError("a forward with dropout (deterministic=False) "
                         "needs dropout_rng, a torch.Generator")
    seeds = site_seeds(dropout_rng, 1 + sites * n_layers)
    return seeds[0], [tuple(seeds[1 + sites * i:1 + sites * (i + 1)])
                      for i in range(n_layers)]


def site_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None for None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def dropout(x: torch.Tensor, rate: float,
            seed: Optional[int]) -> torch.Tensor:
    """flax ``nn.Dropout``: elements kept with probability ``1 - rate``
    are scaled by ``1 / (1 - rate)``, the rest are 0; the identity when
    ``seed`` is None or ``rate`` is 0."""
    if seed is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=site_generator(seed, x.device),
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
