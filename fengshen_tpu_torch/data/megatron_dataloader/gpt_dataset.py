"""GPT pretraining samples: contiguous tokens packed over an indexed
corpus. The port of ``fengshen_tpu/data/megatron_dataloader/
gpt_dataset.py`` (:26-118).

Documents are shuffled per epoch by ``RandomState(seed)``, unrolled into
their sentences, and cut into windows of ``seq_length + 1`` tokens by
:func:`..helpers.build_sample_idx`, each window starting on the last
token of the one before. With ``cache_dir`` the boundaries are saved as
``<name>_sample_idx_<key>.npy`` (the JAX package's md5 key and file
name, so a cache written by either package is read by the other),
written under a temporary name and renamed into place, and memory-mapped
by later runs.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from fengshen_tpu_torch.data.megatron_dataloader.helpers import \
    build_sample_idx
from fengshen_tpu_torch.data.megatron_dataloader.indexed_dataset import (
    MMapIndexedDataset)


def sequence_order(doc_idx: np.ndarray, doc_order: np.ndarray
                   ) -> np.ndarray:
    """The sentences of ``doc_order``'s documents in that order, int32
    (``doc_idx[d]`` to ``doc_idx[d + 1]`` for each ``d``)."""
    doc_idx = np.asarray(doc_idx, np.int64)
    starts = doc_idx[doc_order]
    lengths = doc_idx[np.asarray(doc_order, np.int64) + 1] - starts
    first = np.cumsum(lengths) - lengths
    return (np.arange(int(lengths.sum()), dtype=np.int64) +
            np.repeat(starts - first, lengths)).astype(np.int32)


class GPTDataset:
    """Samples ``{input_ids, labels}`` of ``seq_length`` int32 tokens."""

    def __init__(self, indexed: MMapIndexedDataset, seq_length: int,
                 seed: int = 0, num_epochs: int = 1,
                 documents: Optional[np.ndarray] = None,
                 cache_dir: Optional[str] = None, name: str = "gpt"):
        self.indexed = indexed
        self.seq_length = seq_length
        if documents is None:
            documents = np.arange(len(indexed.doc_idx) - 1, dtype=np.int32)
        rng = np.random.RandomState(seed)
        doc_order = np.concatenate(
            [rng.permutation(documents).astype(np.int32)
             for _ in range(num_epochs)])
        self.seq_order = sequence_order(indexed.doc_idx, doc_order)
        sizes = np.asarray(indexed.sizes, np.int32)
        self.sample_idx = self._cached_sample_idx(
            sizes, self.seq_order, seq_length, num_epochs, seed, cache_dir,
            name)

    @staticmethod
    def _cached_sample_idx(sizes, seq_order, seq_length, num_epochs, seed,
                           cache_dir, name) -> np.ndarray:
        def built():
            return build_sample_idx(sizes, seq_order, seq_length,
                                    num_epochs, int(sizes[seq_order].sum()))

        if cache_dir is None:
            return built()
        key = hashlib.md5(
            f"{name}-{seq_length}-{num_epochs}-{seed}-"
            f"{len(seq_order)}".encode()).hexdigest()[:16]
        cache = os.path.join(cache_dir, f"{name}_sample_idx_{key}.npy")
        if os.path.exists(cache):
            return np.load(cache, mmap_mode="r")
        idx = built()
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache[:-len(".npy")] + f".tmp{os.getpid()}.npy"
        np.save(tmp, idx)
        os.replace(tmp, cache)
        return idx

    def __len__(self) -> int:
        return len(self.sample_idx) - 1

    def __getitem__(self, idx: int) -> dict:
        """The first ``seq_length`` tokens of the window (its last token
        is the next sample's first), padded with 0; ``labels`` are the
        same tokens unshifted (the module shifts), -100 on padding."""
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            parts = [self.indexed.get(int(self.seq_order[doc_f]),
                                      offset=int(off_f),
                                      length=int(off_l - off_f) + 1)]
        else:
            parts = [self.indexed.get(int(self.seq_order[doc_f]),
                                      offset=int(off_f))]
            for d in range(int(doc_f) + 1, int(doc_l)):
                parts.append(self.indexed[int(self.seq_order[d])])
            if doc_l < len(self.seq_order):
                parts.append(self.indexed.get(int(self.seq_order[doc_l]),
                                              length=int(off_l) + 1))
        tokens = np.concatenate(parts)[: self.seq_length]
        n_valid = len(tokens)
        if n_valid < self.seq_length:
            tokens = np.pad(tokens, (0, self.seq_length - n_valid))
        labels = tokens.astype(np.int32).copy()
        labels[n_valid:] = -100
        return {"input_ids": tokens.astype(np.int32), "labels": labels}
