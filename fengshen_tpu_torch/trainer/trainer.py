"""The Trainer: the one-device core of ``fengshen_tpu/trainer/trainer.py``.

Ported: the flag surface of ``add_trainer_args`` (:133, same names and
defaults, plus ``--device``), ``_make_grad_step`` (:315: gradient
accumulation, the ``loss`` and ``grad_norm`` metrics),
``_make_update_applier`` (:378: the step guards, on by default) and the
core of ``_fit`` (:819: seed, total steps, ``max_steps``, the step loop
over epochs and the log line).

Not yet ported, and refused with ``NotImplementedError`` when a flag asks
for it: a mesh of more than one device, offload, the AOT cache,
checkpoint callbacks, validation (the datamodule refuses a validation
split), profiling, the metrics server,
``steps_per_execution`` > 1, rewinds, retrying loaders and fault plans.
The port's Trainer installs no signal handler: preemption belongs to the
resilience slice.

The device is ``--device`` (default ``cuda``, which raises without a
card); batches are numpy dicts from the datamodule, moved to the device
per step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.trainer.module import TrainModule
from fengshen_tpu_torch.trainer.train_state import TrainState

_NOT_PORTED = "is not yet ported in fengshen_tpu_torch"


def add_trainer_args(parent_parser: argparse.ArgumentParser):
    """The reference's Trainer flags (same names and defaults), its
    resilience and mesh groups, and ``--device``."""
    parser = parent_parser.add_argument_group("Trainer")
    parser.add_argument("--max_steps", default=-1, type=int)
    parser.add_argument("--max_epochs", default=1, type=int)
    parser.add_argument("--val_check_interval", default=0, type=float)
    parser.add_argument("--limit_val_batches", default=0, type=int)
    parser.add_argument("--log_every_n_steps", default=10, type=int)
    parser.add_argument("--steps_per_execution", default=1, type=int)
    parser.add_argument("--accumulate_grad_batches", default=1, type=int)
    parser.add_argument("--gradient_clip_val", default=0.0, type=float)
    parser.add_argument("--precision", default="bf16", type=str,
                        choices=["bf16", "fp32", "16", "32", "bf16-mixed"])
    parser.add_argument(
        "--offload", default="auto", type=str,
        choices=["auto", "none", "opt", "opt_master", "stream"],
        help="'auto' and 'none' keep everything on the device; the "
             "offload levels are not yet ported")
    parser.add_argument("--offload_memory_kind", default="auto", type=str,
                        choices=["auto", "pinned_host", "unpinned_host"])
    parser.add_argument("--offload_optimizer", action="store_true",
                        default=False)
    parser.add_argument("--profile_steps", default=None, type=str)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--default_root_dir", default="./runs", type=str)
    parser.add_argument("--metrics_port", default=0, type=int)
    parser.add_argument("--aot_cache_dir", default=None, type=str)
    parser.add_argument(
        "--device", default=None, type=str,
        help="torch device to train on; default cuda (raises without a "
             "card); 'cpu' runs on the CPU")
    resil = parent_parser.add_argument_group("resilience")
    resil.add_argument("--disable_step_guards", action="store_true",
                       default=False)
    resil.add_argument("--skip_steps_with_grad_norm_above", default=0.0,
                       type=float)
    resil.add_argument("--max_consecutive_bad_steps", default=0, type=int)
    resil.add_argument("--max_rewinds", default=2, type=int)
    resil.add_argument("--loader_max_retries", default=0, type=int)
    resil.add_argument("--loader_backoff_base", default=0.5, type=float)
    resil.add_argument("--loader_skip_batches", default=0, type=int)
    mesh = parent_parser.add_argument_group("MeshConfig")
    mesh.add_argument("--data_parallel_size", default=-1, type=int)
    mesh.add_argument("--fsdp_parallel_size", default=1, type=int)
    mesh.add_argument("--pipe_model_parallel_size", default=1, type=int)
    mesh.add_argument("--sequence_parallel_size", default=1, type=int)
    mesh.add_argument("--expert_parallel_size", default=1, type=int)
    mesh.add_argument("--tensor_model_parallel_size", default=1, type=int)
    return parent_parser


def _refuse_unported(args) -> None:
    """``NotImplementedError`` for every flag set to what this slice
    leaves out."""
    def arg(name, default=None):
        return getattr(args, name, default)

    mesh = {name: arg(name, 1) for name in (
        "fsdp_parallel_size", "pipe_model_parallel_size",
        "sequence_parallel_size", "expert_parallel_size",
        "tensor_model_parallel_size")}
    mesh["data_parallel_size"] = 1 if arg("data_parallel_size", -1) in \
        (-1, 1) else arg("data_parallel_size")
    wide = {k: v for k, v in mesh.items() if v != 1}
    checks = [
        (wide, f"a mesh beyond one device ({wide})"),
        (arg("offload", "auto") not in ("auto", "none") or
         arg("offload_optimizer", False) or
         arg("offload_memory_kind", "auto") != "auto", "offload"),
        (arg("aot_cache_dir"), "the AOT cache (--aot_cache_dir)"),
        (arg("profile_steps"), "profiling (--profile_steps)"),
        (arg("metrics_port", 0), "the metrics server (--metrics_port)"),
        (arg("steps_per_execution", 1) > 1, "--steps_per_execution > 1"),
        (arg("max_consecutive_bad_steps", 0),
         "rewinds (--max_consecutive_bad_steps)"),
        (arg("loader_max_retries", 0) or arg("loader_skip_batches", 0),
         "retrying loaders (--loader_max_retries/--loader_skip_batches)"),
        (arg("val_check_interval", 0) or arg("limit_val_batches", 0),
         "validation (--val_check_interval/--limit_val_batches)"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} {_NOT_PORTED}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class Trainer:
    def __init__(self, args: Any):
        _refuse_unported(args)
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        self.global_step = 0
        self.consumed_samples = 0
        self.callbacks: list = []
        #: deterministic fault-injection plans are not ported; must stay None
        self.fault_plan = None
        #: every logged entry, in order (also written to metrics.jsonl)
        self.history: list = []
        self.state: Optional[TrainState] = None
        self._log_path = os.path.join(
            getattr(args, "default_root_dir", "./runs"), "metrics.jsonl")

    # -- step ------------------------------------------------------------
    def _make_grad_step(self, module: TrainModule):
        """``grad_step(batch) -> metrics``: zero the gradients, then
        forward and backward over ``accumulate_grad_batches`` equal
        micro-batches (their mean loss and mean gradient, as the
        reference's scan). ``loss`` and ``grad_norm`` (before clipping)
        join the module's metrics, as device tensors."""
        accum = max(int(getattr(self.args, "accumulate_grad_batches", 1)),
                    1)
        model = module.model
        params = [p for p in model.parameters() if p.requires_grad]

        def grad_step(batch: dict) -> dict:
            for p in params:
                p.grad = None
            if accum == 1:
                loss, metrics = module.training_loss(batch)
                loss.backward()
                metrics = dict(metrics)
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % accum:
                    raise ValueError(f"batch of {rows} rows does not split "
                                     f"into {accum} micro-batches")
                size = rows // accum
                loss, sums, last = 0.0, {}, {}
                for i in range(accum):
                    mb = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                    l, m = module.training_loss(mb)
                    (l / accum).backward()
                    loss = loss + l.detach()
                    for k, v in m.items():
                        if torch.is_floating_point(v):
                            sums[k] = sums.get(k, 0.0) + v.detach()
                        else:
                            last[k] = v
                loss = loss / accum
                metrics = {**last, **{k: v / accum for k, v in sums.items()}}
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = global_norm(
                [p.grad for p in params if p.grad is not None])
            return metrics

        return grad_step

    def _guard_config(self) -> tuple[bool, float]:
        return (not getattr(self.args, "disable_step_guards", False),
                float(getattr(self.args,
                              "skip_steps_with_grad_norm_above", 0.0)
                      or 0.0))

    def _make_update_applier(self):
        """``apply_update(state, metrics) -> (state, metrics)``: guarded
        by default (a non-finite or spiking step is skipped and counted),
        unconditional under ``--disable_step_guards``."""
        from fengshen_tpu_torch.resilience.guards import (guarded_apply,
                                                          step_ok)
        guards_on, spike = self._guard_config()

        def apply_update(state: TrainState, metrics: dict):
            if guards_on:
                state = guarded_apply(state, step_ok(metrics, spike))
            else:
                state.apply_gradients()
            metrics["bad_step_count"] = state.bad_step_count
            return state, metrics

        return apply_update

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                for k, v in batch.items()}

    # -- fit -------------------------------------------------------------
    def fit(self, module: TrainModule, datamodule) -> TrainState:
        if self.callbacks:
            raise NotImplementedError(
                f"trainer callbacks (checkpointing) {_NOT_PORTED}")
        if self.fault_plan is not None:
            raise NotImplementedError(f"fault plans {_NOT_PORTED}")
        return self._fit(module, datamodule)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fit(self, module: TrainModule, datamodule) -> TrainState:
        args = self.args
        module.setup("fit")
        datamodule.trainer = self
        seed = getattr(args, "seed", 42)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        meta_loader = datamodule.train_dataloader()
        dataset_len = getattr(meta_loader, "num_samples",
                              None) or len(meta_loader)
        world_batch = getattr(meta_loader, "global_batch_size", 1)
        from fengshen_tpu_torch.models.model_utils import get_total_steps
        total_steps = get_total_steps(args, dataset_len, world_batch)
        max_steps = getattr(args, "max_steps", -1)
        if max_steps is None or max_steps <= 0:
            max_steps = total_steps
        sample = meta_loader.peek() if hasattr(meta_loader, "peek") \
            else next(iter(meta_loader))

        model = module.init_params(generator)
        optimizer, scheduler = module.configure_optimizers(total_steps,
                                                           model)
        state = TrainState.create(model, optimizer, scheduler,
                                  getattr(args, "gradient_clip_val", 0.0))
        self.state = state
        self._schedule = scheduler.schedule
        train_loader = datamodule.train_dataloader()
        grad_step = self._make_grad_step(module)
        apply_update = self._make_update_applier()

        n_params = sum(p.numel() for p in model.parameters())
        self._log({"event": "fit_start", "n_params": int(n_params),
                   "total_steps": int(total_steps),
                   "device": str(self.device),
                   "batch_shape": {k: list(np.shape(v))
                                   for k, v in sample.items()}})
        log_every = max(int(getattr(args, "log_every_n_steps", 10)), 1)
        flops_per_tok = module.flops_per_token() or 6.0 * float(n_params)
        self._sync()
        window_t0, window_tokens = time.perf_counter(), 0

        epoch, done = 0, self.global_step >= max_steps
        while not done:
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            for batch in train_loader:
                metrics = grad_step(self._to_device(batch))
                state, metrics = apply_update(state, metrics)
                self.global_step += 1
                self.consumed_samples += world_batch
                window_tokens += module.tokens_in_batch(batch)
                if self.global_step % log_every == 0:
                    self._sync()
                    dt = time.perf_counter() - window_t0
                    entry = {"step": self.global_step,
                             "lr": float(self._schedule(self.global_step)),
                             "consumed_samples": self.consumed_samples,
                             **{k: float(v) for k, v in metrics.items()},
                             "tokens_per_sec": window_tokens / dt,
                             "step_time_s": dt / log_every,
                             "flops_per_token": flops_per_tok}
                    self._log(entry)
                    window_t0, window_tokens = time.perf_counter(), 0
                if self.global_step >= max_steps:
                    done = True
                    break
            epoch += 1
            if getattr(args, "max_epochs", 1) and \
                    epoch >= max(getattr(args, "max_epochs", 1), 1):
                done = True
        self._log({"event": "fit_end", "step": self.global_step})
        return state

    # -- logging ---------------------------------------------------------
    def _log(self, entry: dict) -> None:
        """One structured event: kept in ``history``, appended to
        ``<default_root_dir>/metrics.jsonl`` and echoed to stdout."""
        self.history.append(entry)
        line = json.dumps(entry, default=str)
        os.makedirs(os.path.dirname(self._log_path) or ".", exist_ok=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")
        print(f"[fengshen-tpu-torch] {line}", file=sys.stdout, flush=True)
