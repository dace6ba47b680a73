"""UniversalDataModule: the port of
``fengshen_tpu/data/universal_datamodule.py`` with its passed-in
datasets and its local-file branch.

Split files (``--train_file`` and friends) are read with the stdlib
``json`` module, as a JSON array or as one JSON object per line; the
reference reads them through HF ``datasets``, which the port does not
use. The train loader is the resumable one (it starts past the
trainer's ``consumed_samples``); the validation and test loaders
(``--val_file``, ``--test_file``: the ``validation`` and ``test``
splits) walk their split in order, batch by batch, the tail short of a
batch dropped, as the reference's ``_SimpleBatchSampler`` does; the
prediction loader walks the test split the same way but keeps every
row, its tail batch filled by cycling its own rows (the sampler's
``drop_last=False``, as the classification example's prediction loader
runs it). Named registry datasets (``--datasets_name``) and csv files
are not yet ported and are refused. Batches are numpy dicts; the
Trainer moves them to the device. There is one data-parallel rank.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Optional

import numpy as np

from fengshen_tpu_torch.data.universal_sampler import (
    PretrainingRandomSampler, PretrainingSampler)


def get_consumed_samples(trainer_or_model: Any, global_batch: int) -> int:
    """The checkpointed ``consumed_samples``, else global_step x batch."""
    consumed = getattr(trainer_or_model, "consumed_samples", None)
    if consumed is not None:
        return int(consumed)
    step = getattr(trainer_or_model, "global_step", 0)
    return int(step * global_batch)


def _default_collate(samples: list) -> dict:
    """Stack dict-of-arrays samples into a numpy batch."""
    if not samples:
        return {}
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    return {"batch": np.stack([np.asarray(s) for s in samples])}


def load_json_records(path: str) -> list:
    """A JSON array of records, or one JSON record per line."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("["):
        return json.loads(text)
    return [json.loads(line) for line in text.splitlines() if line.strip()]


class DataLoader:
    """Sampler-driven host loader yielding numpy batches."""

    def __init__(self, dataset, sampler, collate_fn: Optional[Callable] = None,
                 global_batch_size: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn or _default_collate
        self.global_batch_size = global_batch_size
        self.num_samples = len(dataset)

    def __len__(self) -> int:
        return max(1, self.num_samples // self.global_batch_size)

    def __iter__(self):
        for indices in self.sampler:
            try:
                batch = self.collate_fn([self.dataset[int(i)]
                                         for i in indices])
            except Exception:  # noqa: BLE001 — always re-raised
                # the stateful sampler already counted these indices:
                # roll it back so a retry sees the same batch
                unconsume = getattr(self.sampler, "unconsume", None)
                if callable(unconsume):
                    unconsume()
                raise
            yield batch

    def set_epoch(self, epoch: int) -> None:
        """The Trainer's per-epoch call, forwarded to a sampler that
        reshuffles per epoch (``_SimpleBatchSampler``); the resumable
        samplers derive their epoch from ``consumed_samples``."""
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def skip_next(self) -> None:
        """``ResilientLoader``'s skip protocol: advance the sampler past
        the next (poison) batch without fetching it."""
        next(iter(self.sampler), None)

    def peek(self):
        """A shape-representative batch without advancing the sampler."""
        micro = getattr(self.sampler, "micro_batch_size", None) or \
            getattr(self.sampler, "batch", 1)
        n = min(micro, self.num_samples)
        return self.collate_fn([self.dataset[i % self.num_samples]
                                for i in range(n)])


class _SimpleBatchSampler:
    """The reference's plain epoch sampler (``_SimpleBatchSampler``,
    ``universal_datamodule.py:94``): batches of ``batch`` indices, in
    order or shuffled per epoch from ``seed + epoch``, this rank's slice
    of each global batch of ``batch * world``. With ``drop_last`` the
    tail short of a global batch is dropped; without it the tail batch
    is filled to ``batch`` rows by cycling the rank's own rows (or the
    global chunk's, when the rank's slice is empty), so every rank
    yields as many batches and duplicates can be dropped by id."""

    def __init__(self, total: int, batch: int, rank: int = 0,
                 world: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.total, self.batch = total, batch
        self.rank, self.world = rank, world
        self.shuffle, self.seed = shuffle, seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        order = np.arange(self.total)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch
                                          ).permutation(self.total)
        global_batch = self.batch * self.world
        usable = self.total - self.total % global_batch if self.drop_last \
            else self.total
        for start in range(0, usable, global_batch):
            chunk = order[start:start + global_batch]
            mine = chunk[self.rank * self.batch:(self.rank + 1) * self.batch]
            if len(mine) < self.batch:
                mine = np.resize(mine if len(mine) else chunk, self.batch)
            yield [int(i) for i in mine]


class UniversalDataModule:
    @staticmethod
    def add_data_specific_args(parent_args: argparse.ArgumentParser):
        """The reference's data flags (same names and defaults)."""
        parser = parent_args.add_argument_group("Universal DataModule")
        parser.add_argument("--num_workers", default=8, type=int)
        parser.add_argument("--dataloader_workers", default=2, type=int)
        parser.add_argument("--train_batchsize", default=16, type=int)
        parser.add_argument("--val_batchsize", default=16, type=int)
        parser.add_argument("--test_batchsize", default=16, type=int)
        parser.add_argument("--datasets_name", type=str, default=None)
        parser.add_argument("--train_datasets_field", type=str,
                            default="train")
        parser.add_argument("--val_datasets_field", type=str,
                            default="validation")
        parser.add_argument("--test_datasets_field", type=str, default="test")
        parser.add_argument("--train_file", type=str, default=None)
        parser.add_argument("--val_file", type=str, default=None)
        parser.add_argument("--test_file", type=str, default=None)
        parser.add_argument("--raw_file_type", type=str, default="json")
        parser.add_argument("--sampler_type", type=str, default="random",
                            choices=["single", "random"])
        parser.add_argument("--use_mpu", action="store_true", default=False)
        return parent_args

    def __init__(self, tokenizer=None, collate_fn: Optional[Callable] = None,
                 args=None, datasets: Optional[dict] = None, **kwargs):
        self.tokenizer = tokenizer
        self.collate_fn = collate_fn
        self.args = args
        self.trainer = None  # set by Trainer.fit for consumed_samples
        if datasets is not None:
            self.datasets = datasets
        elif getattr(args, "datasets_name", None) is not None:
            raise NotImplementedError(
                "named registry datasets (--datasets_name) are not yet "
                "ported; pass --train_file")
        elif any(getattr(args, attr, None) for attr in
                 ("train_file", "val_file", "test_file")):
            file_type = getattr(args, "raw_file_type", "json")
            if file_type != "json":
                raise NotImplementedError(
                    f"--raw_file_type {file_type!r} is not yet ported "
                    "(json and jsonl files are)")
            self.datasets = {}
            for split, attr in (("train", "train_file"),
                                ("validation", "val_file"),
                                ("test", "test_file")):
                if getattr(args, attr, None):
                    self.datasets[split] = load_json_records(
                        getattr(args, attr))
        else:
            self.datasets = {}

    def train_dataloader(self):
        """The resumable train loader: a seeded random (or, with
        ``--sampler_type single``, sequential) sampler that starts past the
        trainer's ``consumed_samples``."""
        ds = self.datasets[getattr(self.args, "train_datasets_field",
                                   "train")]
        batch_size = getattr(self.args, "train_batchsize", 16)
        consumed = 0 if self.trainer is None else \
            get_consumed_samples(self.trainer, batch_size)
        if getattr(self.args, "sampler_type", "random") == "random":
            sampler = PretrainingRandomSampler(
                total_samples=len(ds), consumed_samples=consumed,
                micro_batch_size=batch_size, data_parallel_rank=0,
                data_parallel_size=1,
                epoch_seed=getattr(self.args, "seed", 42))
        else:
            sampler = PretrainingSampler(
                total_samples=len(ds), consumed_samples=consumed,
                micro_batch_size=batch_size, data_parallel_rank=0,
                data_parallel_size=1)
        return DataLoader(ds, sampler, self.collate_fn,
                          global_batch_size=batch_size)

    def val_dataloader(self):
        """The validation loader over the ``val_datasets_field`` split
        (``--val_batchsize`` rows, in order, the tail short of a batch
        dropped), or None without that split."""
        field = getattr(self.args, "val_datasets_field", "validation")
        ds = self.datasets.get(field)
        if ds is None:
            return None
        return self._in_order(ds, getattr(self.args, "val_batchsize", 16))

    def test_dataloader(self):
        """The test loader over the ``test_datasets_field`` split
        (``--test_batchsize`` rows, in order, the tail short of a batch
        dropped, :244), or None without that split."""
        ds = self.datasets.get(getattr(self.args, "test_datasets_field",
                                       "test"))
        if ds is None:
            return None
        return self._in_order(ds, getattr(self.args, "test_batchsize", 16))

    def predict_dataloader(self):
        """The prediction loader over the test split: as
        :meth:`test_dataloader`, but every row is kept (the tail batch
        filled by cycling its rows); None without that split."""
        ds = self.datasets.get(getattr(self.args, "test_datasets_field",
                                       "test"))
        if ds is None:
            return None
        return self._in_order(ds, getattr(self.args, "test_batchsize", 16),
                              drop_last=False)

    def _in_order(self, ds, batch_size: int, drop_last: bool = True):
        seed = getattr(self.args, "seed", 42)
        return DataLoader(ds, _SimpleBatchSampler(
            len(ds), batch_size, seed=seed, drop_last=drop_last),
            self.collate_fn, global_batch_size=batch_size)
