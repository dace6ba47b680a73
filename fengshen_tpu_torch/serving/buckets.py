"""Prefill bucket ladder: the port's own copy of
``fengshen_tpu/serving/buckets.py:22 BucketLadder``.

Every prompt is padded LEFT to the smallest bucket of a short ladder
(default 64/128/256/512). In the reference that bounds the set of
compiled prefill programs; in the port it keeps prefill shapes, and so
the engine's outputs, identical to the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

#: geometric ladder; tune per deployment
DEFAULT_BUCKETS = (64, 128, 256, 512)


class BucketLadder:
    """Smallest-bucket-that-fits selection plus left-padding."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        buckets = tuple(int(b) for b in buckets)
        if not buckets:
            raise ValueError("BucketLadder needs at least one bucket")
        if any(b <= 0 for b in buckets) or \
                any(a >= b for a, b in zip(buckets, buckets[1:])):
            raise ValueError(
                f"buckets must be positive and strictly ascending: "
                f"{buckets}")
        self.buckets = buckets

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, length: int) -> Optional[int]:
        """Smallest bucket >= length; None when the prompt outgrows the
        ladder (the engine rejects instead of silently truncating)."""
        if length <= 0:
            raise ValueError(f"prompt length must be positive: {length}")
        for b in self.buckets:
            if length <= b:
                return b
        return None

    def pad_prompt(self, ids, bucket: int, pad_token_id: int = 0):
        """LEFT-pad `ids` (1-D int sequence) to `bucket`; returns
        (ids [bucket], mask [bucket]) int32 numpy rows. Left padding
        keeps the last real token in the last column, so the prefill's
        final-position logits are the next-token logits — exactly
        `utils.generate.generate`'s convention."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if len(ids) > bucket:
            raise ValueError(f"prompt of {len(ids)} tokens does not fit "
                             f"bucket {bucket}")
        out = np.full((bucket,), pad_token_id, np.int32)
        mask = np.zeros((bucket,), np.int32)
        out[bucket - len(ids):] = ids
        mask[bucket - len(ids):] = 1
        return out, mask
