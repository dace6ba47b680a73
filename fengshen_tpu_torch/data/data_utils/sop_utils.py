"""Sentence-order-prediction pairing: the port of
``fengshen_tpu/data/data_utils/sop_utils.py`` (``get_a_and_b_segments``,
:7)."""

from __future__ import annotations


def get_a_and_b_segments(sample: list[list[int]], np_rng
                         ) -> tuple[list[int], list[int], bool]:
    """Split a sample of two or more sentences into two segments at a
    boundary drawn from ``np_rng``; with probability 0.5 swap them (the
    SOP label True means swapped)."""
    n_sentences = len(sample)
    assert n_sentences > 1, "need at least two sentences for SOP"
    a_end = 1 if n_sentences == 2 else np_rng.randint(1, n_sentences)
    tokens_a: list[int] = []
    for s in sample[:a_end]:
        tokens_a.extend(s)
    tokens_b: list[int] = []
    for s in sample[a_end:]:
        tokens_b.extend(s)

    is_next_random = bool(np_rng.random() < 0.5)
    if is_next_random:
        tokens_a, tokens_b = tokens_b, tokens_a
    return tokens_a, tokens_b, is_next_random
