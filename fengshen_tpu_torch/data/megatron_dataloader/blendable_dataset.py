"""Weighted blending of several datasets: the port of
``fengshen_tpu/data/megatron_dataloader/blendable_dataset.py`` (:15-34),
its order from :func:`..helpers.build_blending_indices`."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from fengshen_tpu_torch.data.megatron_dataloader.helpers import (
    build_blending_indices)


class BlendableDataset:
    """``size`` samples (default: the datasets' total) drawn from
    ``datasets`` in proportion to ``weights``; a dataset asked for more
    samples than it has wraps around."""

    def __init__(self, datasets: Sequence, weights: Sequence[float],
                 size: Optional[int] = None):
        if len(datasets) != len(weights):
            raise ValueError("datasets and weights length mismatch")
        self.datasets = list(datasets)
        if size is None:
            size = sum(len(d) for d in datasets)
        self.size = size
        self.dataset_index, self.dataset_sample_index = \
            build_blending_indices(np.asarray(weights, np.float64), size)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        d = int(self.dataset_index[idx])
        s = int(self.dataset_sample_index[idx]) % len(self.datasets[d])
        return self.datasets[d][s]
