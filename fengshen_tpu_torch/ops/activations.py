"""Activation functions: the port of ``fengshen_tpu/ops/activations.py``.

``get_activation`` dispatches by the same names. ``"gelu"`` is the exact
erf form and ``"gelu_new"`` the tanh approximation, as HF names them
(:29-41); ``"geglu"`` gates one half of a doubled feature dim with the
gelu of the other.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def geglu_split(x: torch.Tensor) -> torch.Tensor:
    """GEGLU over a doubled feature dim: ``a * gelu(b)``, the reference's
    ``jax.nn.gelu`` default being the tanh form."""
    a, b = torch.chunk(x, 2, dim=-1)
    return a * F.gelu(b, approximate="tanh")


_ACTIVATIONS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "geglu": geglu_split,
    "relu": F.relu,
    "softsign": F.softsign,
    "swish": F.silu,
    "silu": F.silu,
    "mish": mish,
    "tanh": torch.tanh,
}


def get_activation(name: str) -> Callable:
    """The activation called ``name`` (case-insensitive); an unknown name
    raises ``ValueError`` listing the known ones."""
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")


def is_gated(name: str) -> bool:
    """Gated activations double the up-projection width."""
    return name.lower() in ("geglu",)
