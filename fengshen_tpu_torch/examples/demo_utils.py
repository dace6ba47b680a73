"""The toy character encoding of the demo entry points when no
tokenizer is given: the port's copy of
``fengshen_tpu/examples/demo_utils.py:10-17``."""

from __future__ import annotations


def toy_encode(text: str, max_len: int = 8) -> list[int]:
    """Deterministic char -> id encoding (ids 3..95, 0 = pad)."""
    ids = [min(3 + (ord(c) % 90), 95) for c in text[:max_len]]
    return ids + [0] * (max_len - len(ids))
