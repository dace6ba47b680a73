"""Pair truncation: the port of
``fengshen_tpu/data/data_utils/truncate_utils.py`` (``truncate_segments``,
:7)."""

from __future__ import annotations


def truncate_segments(tokens_a: list, tokens_b: list, len_a: int, len_b: int,
                      max_num_tokens: int, np_rng) -> bool:
    """Trim the pair in place to ``max_num_tokens``: each round drops one
    token of the longer segment (B on a tie), from its front or its back
    as ``np_rng`` draws. Returns True if anything was cut."""
    truncated = False
    while len_a + len_b > max_num_tokens:
        if len_a > len_b:
            tokens = tokens_a
            len_a -= 1
        else:
            tokens = tokens_b
            len_b -= 1
        if np_rng.random() < 0.5:
            del tokens[0]
        else:
            tokens.pop()
        truncated = True
    return truncated
