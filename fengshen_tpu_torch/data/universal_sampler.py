"""Resumable deterministic samplers: the port's own copy of
``fengshen_tpu/data/universal_sampler.py`` (pure numpy, so the same
seed gives the same batches in both packages), itself a port of the
Megatron-style samplers of Fengshenbang-LM
(``fengshen/data/universal_datamodule/universal_sampler.py``):
- `PretrainingSampler` — sequential order, resumes by skipping
  `consumed_samples` (:22-60).
- `PretrainingRandomSampler` — per-epoch seeded shuffle inside this
  data-parallel rank's bucket, resuming mid-epoch via
  `consumed_samples % active_total` (:63-125).

Both yield micro-batches of indices for ONE data-parallel rank; determinism
across ranks comes from seeding with the epoch only (same permutation on
every host). The math is pure index arithmetic, so these are plain Python
iterables — no torch Sampler base class needed.
"""

from __future__ import annotations

import numpy as np


class PretrainingSampler:
    #: iteration does NOT mutate consumed_samples — re-entering restarts
    #: from the construction-time position (see ResilientLoader)
    resumes_mid_epoch = False

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True):
        if total_samples <= 0:
            raise ValueError(f"no samples to consume: {total_samples}")
        if consumed_samples >= total_samples:
            raise ValueError("consumed_samples >= total_samples "
                             f"({consumed_samples} >= {total_samples})")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError("data_parallel_rank >= data_parallel_size "
                             f"({data_parallel_rank} >= {data_parallel_size})")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.drop_last = drop_last
        self.global_batch = micro_batch_size * data_parallel_size

    def __len__(self) -> int:
        return self.total_samples

    def _rank_slice(self, batch: list[int]) -> list[int]:
        start = self.data_parallel_rank * self.micro_batch_size
        return batch[start:start + self.micro_batch_size]

    def __iter__(self):
        batch: list[int] = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.global_batch:
                yield self._rank_slice(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._rank_slice(batch)


class PretrainingRandomSampler:
    #: consumed_samples advances as batches are yielded, so re-entering
    #: (`iter()` again) resumes mid-epoch — the property ResilientLoader
    #: keys its retry semantics on
    resumes_mid_epoch = True

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, epoch_seed: int = 0):
        if total_samples <= 0:
            raise ValueError(f"no samples to consume: {total_samples}")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError("data_parallel_rank >= data_parallel_size "
                             f"({data_parallel_rank} >= {data_parallel_size})")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.epoch_seed = epoch_seed
        self.global_batch = micro_batch_size * data_parallel_size
        # samples beyond the last full global batch are dropped each epoch
        self.active_total = total_samples - total_samples % self.global_batch
        if self.active_total <= 0:
            raise ValueError(
                f"total_samples {total_samples} < one global batch "
                f"{self.global_batch}")

    def __len__(self) -> int:
        return self.total_samples

    @property
    def epoch(self) -> int:
        return self.consumed_samples // self.active_total

    def __iter__(self):
        epoch = self.epoch
        # position within the current epoch, split across DP ranks
        current = self.consumed_samples % self.active_total
        bucket_size = self.active_total // self.data_parallel_size
        bucket_offset = current // self.data_parallel_size
        start = self.data_parallel_rank * bucket_size

        rng = np.random.RandomState(self.epoch_seed + epoch)
        order = start + rng.permutation(bucket_size)
        order = order[bucket_offset:]

        batch: list[int] = []
        for idx in order:
            batch.append(int(idx))
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += self.global_batch
                yield batch
                batch = []

    def unconsume(self) -> None:
        """Roll the cursor back one global batch: the DataLoader calls
        this when fetching the just-yielded indices fails, so a
        ResilientLoader re-entry retries the SAME batch instead of
        silently dropping it."""
        self.consumed_samples = max(0, self.consumed_samples -
                                    self.global_batch)
