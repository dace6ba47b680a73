"""UniversalDataModule: the port of
``fengshen_tpu/data/universal_datamodule.py`` with its passed-in
datasets and its local-file branch.

Split files (``--train_file`` and friends) are read with the stdlib
``json`` module, as a JSON array or as one JSON object per line; the
reference reads them through HF ``datasets``, which the port does not
use. The train loader is the resumable one (it starts past the
trainer's ``consumed_samples``); the validation loader (``--val_file``,
the ``validation`` split) walks its split in order, batch by batch, as
the reference's ``_SimpleBatchSampler`` does. Named registry datasets
(``--datasets_name``), csv files and the test split are not yet ported
and are refused. Batches are numpy dicts; the Trainer moves them to the
device. There is one data-parallel rank.
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
    """The validation sampler of the reference (``_SimpleBatchSampler``,
    ``universal_datamodule.py:94``, unshuffled) on one rank: batches of
    ``batch`` indices in order, the tail short of a full batch
    dropped."""

    def __init__(self, total: int, batch: int):
        self.total, self.batch = total, batch

    def __iter__(self):
        for start in range(0, self.total - self.total % self.batch,
                           self.batch):
            yield list(range(start, start + self.batch))


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
        known = (getattr(args, "train_datasets_field", "train"),
                 getattr(args, "val_datasets_field", "validation"))
        others = [k for k, v in self.datasets.items()
                  if k not in known and v is not None]
        if others:
            raise NotImplementedError(
                f"splits {others}: test and prediction loaders are not "
                "yet ported (the train and validation splits are)")

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
        batch_size = getattr(self.args, "val_batchsize", 16)
        return DataLoader(ds, _SimpleBatchSampler(len(ds), batch_size),
                          self.collate_fn,
                          global_batch_size=batch_size)
