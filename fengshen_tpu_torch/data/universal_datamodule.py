"""UniversalDataModule: the port of
``fengshen_tpu/data/universal_datamodule.py`` with its passed-in
datasets and its local-file branch.

Split files (``--train_file`` and friends) are read with the stdlib
``json`` module, as a JSON array or as one JSON object per line; the
reference reads them through HF ``datasets``, which the port does not
use. Named registry datasets (``--datasets_name``) and csv files are not
yet ported, nor are validation and prediction loaders: a split other
than the train split is refused. Batches are numpy dicts; the Trainer
moves them to the device. There is one data-parallel rank.
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
            yield self.collate_fn([self.dataset[int(i)] for i in indices])

    def peek(self):
        """A shape-representative batch without advancing the sampler."""
        n = min(self.sampler.micro_batch_size, self.num_samples)
        return self.collate_fn([self.dataset[i % self.num_samples]
                                for i in range(n)])


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
        train_field = getattr(args, "train_datasets_field", "train")
        others = [k for k, v in self.datasets.items()
                  if k != train_field and v is not None]
        if others:
            raise NotImplementedError(
                f"splits {others}: validation and prediction loaders are "
                "not yet ported (the port trains on the train split)")

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
