"""The Trainer: the one-device port of ``fengshen_tpu/trainer/trainer.py``.

Ported: the flag surface of ``add_trainer_args`` (:133, same names and
defaults but ``--metrics_port``, plus ``--device``), the process-wide
SIGTERM handler (:275-312), ``_make_grad_step`` (:315: gradient
accumulation, the ``loss`` and ``grad_norm`` metrics, a fault plan's NaN
steps), ``_make_update_applier`` (:378: the step guards, on by default),
``_fit`` (:819) without offload, the AOT cache and
``steps_per_execution``: checkpoint restore, the step loop with its log
line (tokens/s, MFU, goodput), validation per crossing or per epoch,
the callbacks with ``prev_global_step``, the rewind on consecutive bad
steps, the synchronous save on preemption, retrying loaders, the
metrics server and a ``torch.profiler`` window; and ``validate``,
``restore_for_predict`` and ``predict``.

Refused with ``NotImplementedError``: a mesh of more than one device
(ROADMAP.md queue 1 item 9), offload and the AOT cache (item 10), and
``--steps_per_execution`` > 1 (it waits for item 1's CUDA graphs: eager
PyTorch has no single program to group).

``--metrics_port`` differs from the reference's: it defaults to off
(None) and 0 picks a free port, where the reference reads 0 as off.

The device is ``--device`` (default ``cuda``, which raises without a
card); batches are numpy dicts from the datamodule, moved to the device
per step.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.observability import (FlightRecorder, JsonlSink,
                                              StepStats, get_registry,
                                              record_build_info)
from fengshen_tpu_torch.trainer.module import TrainModule
from fengshen_tpu_torch.trainer.train_state import TrainState

_NOT_PORTED = "is not yet ported in fengshen_tpu_torch"

#: process-wide SIGTERM plumbing (see _install_preemption_handler): one
#: handler, re-pointed at the latest Trainer through a weakref
_SIGTERM_STATE: dict = {"handler": None, "prev": None, "ref": None}


def add_trainer_args(parent_parser: argparse.ArgumentParser):
    """The reference's Trainer flags (same names and defaults, but
    ``--metrics_port``), its resilience and mesh groups, and
    ``--device``."""
    parser = parent_parser.add_argument_group("Trainer")
    parser.add_argument("--max_steps", default=-1, type=int)
    parser.add_argument("--max_epochs", default=1, type=int)
    parser.add_argument("--val_check_interval", default=0, type=float,
                        help="steps between validation runs (0 = per epoch)")
    parser.add_argument("--limit_val_batches", default=0, type=int)
    parser.add_argument("--log_every_n_steps", default=10, type=int)
    parser.add_argument("--steps_per_execution", default=1, type=int,
                        help="values above 1 are not yet ported")
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
    parser.add_argument(
        "--profile_steps", default=None, type=str,
        help="START,END step range traced with torch.profiler (a Chrome "
             "trace under default_root_dir/profile)")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--default_root_dir", default="./runs", type=str)
    parser.add_argument(
        "--metrics_port", default=None, type=int,
        help="serve GET /metrics (Prometheus text) from an exporter "
             "thread on this port during fit; 0 picks a free port; "
             "default off")
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
    resil.add_argument(
        "--max_consecutive_bad_steps", default=0, type=int,
        help="after this many consecutive guarded-away steps, restore "
             "the last checkpoint and skip the offending data window "
             "(0 = never rewind)")
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
    """``NotImplementedError`` for every flag set to what the port leaves
    out, naming its ROADMAP.md queue 1 item."""
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
        (wide, f"a mesh beyond one device ({wide}) (queue 1 item 9)"),
        (arg("offload", "auto") not in ("auto", "none") or
         arg("offload_optimizer", False) or
         arg("offload_memory_kind", "auto") != "auto",
         "offload (queue 1 item 10)"),
        (arg("aot_cache_dir"),
         "the AOT cache (--aot_cache_dir) (queue 1 item 10)"),
        (arg("steps_per_execution", 1) > 1,
         "--steps_per_execution > 1 (queue 1 item 1: CUDA graphs)"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} {_NOT_PORTED}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def _crossed(prev: int, cur: int, every: int) -> bool:
    """Did ``[prev + 1, cur]`` contain a multiple of ``every``?"""
    return every > 0 and (cur // every) > (prev // every)


class Trainer:
    def __init__(self, args: Any):
        _refuse_unported(args)
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        self.global_step = 0
        self.consumed_samples = 0
        self.callbacks: list = []
        #: deterministic fault-injection plan (``resilience.FaultPlan``)
        self.fault_plan = None
        #: every logged entry, in order (also written to metrics.jsonl)
        self.history: list = []
        self.state: Optional[TrainState] = None
        #: the last ``--profile_steps`` window's ``torch.profiler``
        self.profiler = None
        root = getattr(args, "default_root_dir", "./runs")
        self._log_path = os.path.join(root, "metrics.jsonl")
        self._sink = JsonlSink(path=self._log_path, echo=True)
        #: every logged entry also enters the recorder's ring; a rewind
        #: dumps it under <root>/flightrec
        self._flightrec = FlightRecorder(
            dump_dir=os.path.join(root, "flightrec"))
        self._flightrec.attach("trainer", self._flight_state)
        self._metrics_server = None
        self._stepstats: Optional[StepStats] = None
        self._preempted = False
        self._fitting = False
        self._rewinds_left = int(getattr(args, "max_rewinds", 2))
        self._install_preemption_handler()

    def _install_preemption_handler(self) -> None:
        """SIGTERM sets the flag on the most recently built Trainer; the
        loop saves and returns at the next step boundary. The previous
        handler is chained. One process-wide handler is installed and
        re-pointed through a weakref however many Trainers are built,
        and only from the main thread. When no fit is running and the
        previous disposition is the default, the signal is re-delivered
        through it, so a process that holds a Trainer between fits still
        terminates on SIGTERM (the reference ignores it there)."""
        import signal
        import threading
        import weakref
        if threading.current_thread() is not threading.main_thread():
            return
        st = _SIGTERM_STATE
        st["ref"] = weakref.ref(self)
        try:
            current = signal.getsignal(signal.SIGTERM)
        except (ValueError, OSError):
            return
        if st["handler"] is not None and current is st["handler"]:
            return
        if st["handler"] is None:
            def handler(signum, frame):
                trainer = st["ref"]() if st["ref"] is not None else None
                if trainer is not None:
                    trainer._preempted = True
                prev = st["prev"]
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL and not (
                        trainer is not None and trainer._fitting):
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            st["handler"] = handler
        try:
            st["prev"] = signal.signal(signal.SIGTERM, st["handler"])
        except (ValueError, OSError):
            pass

    # -- step ------------------------------------------------------------
    def _make_grad_step(self, module: TrainModule):
        """``grad_step(batch, step) -> metrics``: zero the gradients,
        then forward and backward over ``accumulate_grad_batches`` equal
        micro-batches (their mean loss and mean gradient, as the
        reference's scan). ``loss`` and ``grad_norm`` (over the trainable
        tensors, before clipping) join the module's metrics, as device
        tensors. A fault plan's NaN steps (``TrainState.step`` values,
        read when the step is built) make ``loss`` NaN there."""
        accum = max(int(getattr(self.args, "accumulate_grad_batches", 1)),
                    1)
        model = module.model
        params = [p for p in model.parameters() if p.requires_grad]
        plan = self.fault_plan
        nan_steps = frozenset(plan.nan_loss_at_steps) \
            if plan is not None else frozenset()

        def grad_step(batch: dict, step: int = 0) -> dict:
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
            if int(step) in nan_steps:
                metrics["loss"] = torch.full_like(metrics["loss"],
                                                  float("nan"))
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

    def _restore_callback(self):
        return next((c for c in self.callbacks
                     if hasattr(c, "maybe_restore")), None)

    # -- resilience ------------------------------------------------------
    def _wrap_loader(self, loader, stage: str = "train"):
        """``loader`` in a ``ResilientLoader`` when
        ``--loader_max_retries`` or ``--loader_skip_batches`` ask for it
        (:646); itself otherwise."""
        retries = int(getattr(self.args, "loader_max_retries", 0) or 0)
        skips = int(getattr(self.args, "loader_skip_batches", 0) or 0)
        if loader is None or (retries <= 0 and skips <= 0):
            return loader
        from fengshen_tpu_torch.resilience import ResilientLoader
        wrapped = ResilientLoader(
            loader, max_retries=retries,
            backoff_base=float(getattr(self.args, "loader_backoff_base",
                                       0.5)),
            skip_batch_budget=skips, log=self._log, stage=stage)
        if skips > 0 and stage == "train" and not wrapped.resumable:
            self._log({"event": "loader_skip_budget_inert",
                       "reason": "train loader is not mid-epoch "
                                 "resumable; skips need the stateful "
                                 "random sampler"})
        return wrapped

    def _rewind(self, state: TrainState, ckpt_cb, bad_steps: int
                ) -> TrainState:
        """Restore this run's last checkpoint (its parameters predate the
        bad window: the guard skipped every bad update) and keep
        ``consumed_samples`` past the data that produced the bad steps
        (:683). The cumulative ``bad_step_count`` is kept, as the
        reference keeps it. Raises without a checkpoint callback, when
        nothing is restorable, and once ``--max_rewinds`` is spent."""
        if ckpt_cb is None:
            raise RuntimeError(
                f"{bad_steps} consecutive bad steps at step "
                f"{self.global_step} and no checkpoint callback to "
                "rewind from — aborting instead of optimizing on "
                "garbage")
        if self._rewinds_left <= 0:
            raise RuntimeError(
                f"rewind budget exhausted (--max_rewinds="
                f"{getattr(self.args, 'max_rewinds', 2)}) and still "
                f"seeing {bad_steps} consecutive bad steps at step "
                f"{self.global_step}")
        self._rewinds_left -= 1
        pre_step = int(self.global_step)
        pre_consumed = int(self.consumed_samples)
        pre_bad = int(state.bad_step_count)
        orig_load = ckpt_cb.load_path
        restores = ckpt_cb.stats["restores"]
        if getattr(ckpt_cb, "save_path", None):
            ckpt_cb.load_path = ckpt_cb.save_path
        try:
            restored = ckpt_cb.maybe_restore(state, self)
        finally:
            ckpt_cb.load_path = orig_load
        if ckpt_cb.stats["restores"] == restores:
            raise RuntimeError(
                f"rewind after {bad_steps} consecutive bad steps found "
                "no restorable checkpoint (set --save_ckpt_path/"
                "--every_n_train_steps)")
        restored.bad_step_count = pre_bad
        self.consumed_samples = max(pre_consumed,
                                    int(self.consumed_samples))
        if self._stepstats is not None:
            self._stepstats.record_rewind(pre_step, int(self.global_step))
        self._log({"event": "rewind", "from_step": pre_step,
                   "to_step": int(self.global_step),
                   "bad_steps": int(bad_steps),
                   "consumed_samples": int(self.consumed_samples),
                   "rewinds_left": self._rewinds_left})
        try:
            self._flightrec.snapshot_metrics([get_registry()], force=True)
            self._flightrec.dump(
                reason="rewind",
                extra={"from_step": pre_step,
                       "to_step": int(self.global_step),
                       "bad_steps": int(bad_steps)})
        except OSError as e:
            # the post-mortem must never fail the rewind saving the run
            self._log({"event": "flightrec_dump_error",
                       "error": str(e)[:200]})
        return restored

    # -- eval entries ----------------------------------------------------
    def restore_for_predict(self, module: TrainModule,
                            stage: str = "predict") -> TrainState:
        """An eval-only state (no optimizer) with the checkpoint's
        weights restored, without a validation sweep (:758)."""
        module.setup(stage)
        generator = torch.Generator(device=self.device).manual_seed(
            getattr(self.args, "seed", 42))
        model = module.init_params(generator)
        state = TrainState.create(model, None, None)
        self.state = state
        ckpt_cb = self._restore_callback()
        prev_step = self.global_step
        if ckpt_cb is not None:
            state = ckpt_cb.maybe_restore(state, self, weights_only=True)
        if self.global_step == prev_step:
            self._log({"event": f"{stage}_no_checkpoint_restored"})
        return state

    def validate(self, module: TrainModule, datamodule) -> TrainState:
        """One validation sweep over the val loader on the restored
        weights, no training (:783)."""
        datamodule.trainer = self
        loader = getattr(datamodule, "val_dataloader", lambda: None)()
        if loader is None:
            raise ValueError(
                "validate() has no validation data — pass --val_file / "
                "a 'validation' split (val_datasets_field="
                f"{getattr(self.args, 'val_datasets_field', 'validation')!r})")
        state = self.restore_for_predict(module, stage="validate")
        self._log({"event": "validate_start", "step": self.global_step})
        self._run_validation(module, datamodule, state)
        return state

    def predict(self, module: TrainModule, dataloader, state=None,
                **kwargs) -> list:
        """``module.predict_step(batch, **kwargs)`` over ``dataloader``
        (:1144), each batch moved to the device; ``state`` is the
        restored or trained state whose model predicts."""
        if state is None:
            raise ValueError("predict needs a state (restore_for_predict "
                             "or fit)")
        if not hasattr(module, "predict_step"):
            raise AttributeError(
                f"{type(module).__name__} defines no predict_step")
        with torch.no_grad():
            return [module.predict_step(self._to_device(batch), **kwargs)
                    for batch in dataloader]

    # -- fit -------------------------------------------------------------
    def fit(self, module: TrainModule, datamodule) -> TrainState:
        self._fitting = True
        try:
            return self._fit(module, datamodule)
        finally:
            self._fitting = False
            # neither the exporter nor the profiler outlives the fit
            self._close_metrics_server()
            if self.profiler is not None and \
                    getattr(self, "_profiling", False):
                self.profiler.stop()
                self._profiling = False

    def _close_metrics_server(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

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
        ckpt_cb = self._restore_callback()
        if ckpt_cb is not None:
            state = ckpt_cb.maybe_restore(state, self)
        # the train loader is made after the restore, so the resumable
        # sampler starts past the restored consumed_samples
        train_loader = self._wrap_loader(datamodule.train_dataloader())
        grad_step = self._make_grad_step(module)
        apply_update = self._make_update_applier()

        n_params = sum(p.numel() for p in model.parameters())
        self._log({"event": "fit_start", "n_params": int(n_params),
                   "n_trainable": int(sum(p.numel()
                                          for p in model.parameters()
                                          if p.requires_grad)),
                   "total_steps": int(total_steps),
                   "device": str(self.device),
                   "batch_shape": {k: list(np.shape(v))
                                   for k, v in sample.items()}})
        flops_per_tok = module.flops_per_token() or 6.0 * float(n_params)
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else self.device.type
        self._stepstats = StepStats(flops_per_token=flops_per_tok,
                                    n_devices=1, device_kind=name)
        record_build_info(device=self.device)
        self._maybe_start_metrics_server()
        log_every = max(int(getattr(args, "log_every_n_steps", 10)), 1)
        val_interval = int(getattr(args, "val_check_interval", 0) or 0)
        profile_range = None
        if getattr(args, "profile_steps", None):
            lo, hi = (int(x) for x in str(args.profile_steps).split(","))
            profile_range = (lo, hi)
            self._profiling = False
        max_consec = int(getattr(args, "max_consecutive_bad_steps", 0)
                         or 0)
        if max_consec and getattr(args, "disable_step_guards", False):
            raise ValueError("--max_consecutive_bad_steps needs the step "
                             "guards; drop --disable_step_guards")
        self._rewinds_left = int(getattr(args, "max_rewinds", 2))
        consec_bad = 0
        prev_bad_total = int(state.bad_step_count)
        skips_credited = 0
        self._sync()
        window_t0, window_steps = time.perf_counter(), 0

        epoch, done = 0, self.global_step >= max_steps
        while not done:
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            rewound = False
            for batch in train_loader:
                skips_snap = getattr(train_loader, "skipped_total", 0)
                if profile_range is not None:
                    self._maybe_profile(profile_range)
                metrics = grad_step(self._to_device(batch), state.step)
                state, metrics = apply_update(state, metrics)
                prev_step = int(self.global_step)
                self.global_step = prev_step + 1
                # callbacks read the span of this step (crossings)
                self.prev_global_step = prev_step
                self.consumed_samples += world_batch
                # credit skipped poison batches when training passes
                # them, so a checkpoint never records a cursor ahead of
                # the data trained on
                if skips_snap > skips_credited:
                    self.consumed_samples += world_batch * (
                        skips_snap - skips_credited)
                    skips_credited = skips_snap
                self._stepstats.record_execution(
                    1, module.tokens_in_batch(batch))
                window_steps += 1
                if _crossed(prev_step, self.global_step, log_every):
                    self._sync()
                    dt = time.perf_counter() - window_t0
                    metrics = {k: float(v) for k, v in metrics.items()}
                    entry = {"step": self.global_step,
                             "lr": float(self._schedule(self.global_step)),
                             "consumed_samples": self.consumed_samples,
                             **metrics}
                    entry.update(self._stepstats.window_entry(
                        self.global_step,
                        bad_step_count=int(metrics["bad_step_count"])))
                    entry.update(step_time_s=dt / window_steps,
                                 flops_per_token=flops_per_tok)
                    self._log(entry)
                    window_t0, window_steps = time.perf_counter(), 0
                if _crossed(prev_step, self.global_step, val_interval):
                    self._run_validation(module, datamodule, state)
                for cb in self.callbacks:
                    if hasattr(cb, "on_train_step_end"):
                        cb.on_train_step_end(self, state)
                if max_consec:
                    bad_total = int(state.bad_step_count)
                    delta, prev_bad_total = (bad_total - prev_bad_total,
                                             bad_total)
                    consec_bad = consec_bad + 1 if delta > 0 else 0
                    if consec_bad >= max_consec:
                        state = self._rewind(state, ckpt_cb, consec_bad)
                        prev_bad_total = int(state.bad_step_count)
                        consec_bad = 0
                        plan = self.fault_plan
                        if plan is not None and plan.nan_loss_at_steps \
                                and plan.clear_nan_on_rewind:
                            # the replayed step numbers must not fire the
                            # injected fault again
                            plan.disarm_nan()
                            grad_step = self._make_grad_step(module)
                        rewound = True
                        break
                if self._preempted:
                    # preemption: save synchronously, then return
                    if ckpt_cb is not None:
                        ckpt_cb.save(state, self, sync=True)
                    self._log({"event": "preempted_saved",
                               "step": self.global_step})
                    return state
                if self.global_step >= max_steps:
                    done = True
                    break
            if rewound:
                # same epoch, fresh loader: the resumable sampler starts
                # past the window that produced the bad steps
                train_loader = self._wrap_loader(
                    datamodule.train_dataloader())
                skips_credited = 0
                continue
            if not done:
                # a skip at the very end of an epoch: settle it here
                tail_skips = getattr(train_loader, "skipped_total", 0)
                if tail_skips > skips_credited:
                    self.consumed_samples += world_batch * (
                        tail_skips - skips_credited)
                    skips_credited = tail_skips
            epoch += 1
            if getattr(args, "max_epochs", 1) and \
                    epoch >= max(getattr(args, "max_epochs", 1), 1):
                done = True
            if not val_interval:
                self._run_validation(module, datamodule, state)

        if profile_range is not None and self._profiling:
            self._stop_profile()
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_end"):
                cb.on_fit_end(self, state)
        self._log({"event": "fit_end", "step": self.global_step})
        return state

    # -- profiling -------------------------------------------------------
    def _maybe_profile(self, profile_range: tuple) -> None:
        """Start a ``torch.profiler`` trace at step ``START`` and stop it
        at ``END`` (:1120); the Chrome trace goes to
        ``<default_root_dir>/profile/trace-<start>-<end>.json``."""
        lo, hi = profile_range
        if getattr(self, "_profile_done", False):
            return
        if not self._profiling and self.global_step >= lo:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.profiler = profile(activities=activities)
            self.profiler.start()
            self._profiling = True
            self._profile_range = profile_range
            self._log({"event": "profile_start", "step": self.global_step,
                       "path": self._profile_dir()})
        elif self._profiling and self.global_step >= hi:
            self._stop_profile()

    def _profile_dir(self) -> str:
        return os.path.join(getattr(self.args, "default_root_dir",
                                    "./runs"), "profile")

    def _stop_profile(self) -> None:
        self._sync()
        self.profiler.stop()
        self._profiling = False
        self._profile_done = True
        lo, hi = self._profile_range
        os.makedirs(self._profile_dir(), exist_ok=True)
        path = os.path.join(self._profile_dir(), f"trace-{lo}-{hi}.json")
        self.profiler.export_chrome_trace(path)
        self._log({"event": "profile_stop", "step": self.global_step,
                   "path": path})

    # -- validation ------------------------------------------------------
    def _run_validation(self, module, datamodule, state) -> None:
        """One sweep over the val loader (at most ``--limit_val_batches``
        batches): ``val_loss`` weighted by batch rows, each metric
        averaged over the batches that emit it, weighted by rows, and
        count-like metrics (``n_*``, ``*_sum``, ``*_count``) summed
        (:1185)."""
        loader = self._wrap_loader(
            getattr(datamodule, "val_dataloader", lambda: None)(),
            stage="val")
        if loader is None:
            return
        limit = getattr(self.args, "limit_val_batches", 0)
        losses, metric_sums = [], {}

        def countlike(k: str) -> bool:
            base = k[4:] if k.startswith("val_") else k
            return (base.startswith("n_") or base.endswith("_sum")
                    or base.endswith("_count"))

        for i, batch in enumerate(loader):
            if limit and i >= limit:
                break
            rows = next((float(np.shape(v)[0]) for v in batch.values()
                         if np.ndim(v) >= 1), 1.0)
            loss, metrics = module.validation_loss(self._to_device(batch))
            for k, v in (metrics or {}).items():
                try:
                    v = float(v)
                except (TypeError, ValueError, RuntimeError):
                    continue           # a non-scalar diagnostic
                s, w = metric_sums.get(k, (0.0, 0.0))
                metric_sums[k] = (s + v, -1.0) if countlike(k) else \
                    (s + v * rows, w + rows)
            losses.append((float(loss), rows))
        if losses:
            total_rows = sum(w for _, w in losses)
            entry = {"step": self.global_step,
                     "val_loss": sum(l * w for l, w in losses)
                     / max(total_rows, 1.0)}
            for k, (total, w) in metric_sums.items():
                key = k if k.startswith("val_") else f"val_{k}"
                entry[key] = total if w < 0 else total / max(w, 1e-9)
            self._log(entry)

    # -- logging ---------------------------------------------------------
    def _log(self, entry: dict) -> None:
        """One structured event: kept in ``history``, recorded in the
        flight recorder's ring, appended to
        ``<default_root_dir>/metrics.jsonl`` and echoed to stdout."""
        self.history.append(entry)
        self._flightrec.record(entry)
        self._sink(entry)

    def _flight_state(self) -> dict:
        """The flight recorder's trainer provider: the cursor and the
        scalar run config (the bundle's ``trainer.json``)."""
        return {
            "step": int(self.global_step),
            "consumed_samples": int(self.consumed_samples),
            "rewinds_left": int(self._rewinds_left),
            "args": {k: v for k, v in
                     sorted(getattr(self.args, "__dict__", {}).items())
                     if isinstance(v, (bool, int, float, str,
                                       type(None)))},
        }

    def _maybe_start_metrics_server(self) -> None:
        """``--metrics_port N``: the exporter thread for the fit (0 picks
        a free port; the ``metrics_server_started`` event names it)."""
        port = getattr(self.args, "metrics_port", None)
        if port is None or port < 0 or self._metrics_server is not None:
            return
        from fengshen_tpu_torch.observability import start_metrics_server
        self._metrics_server = start_metrics_server(int(port))
        self._log({"event": "metrics_server_started",
                   "port": self._metrics_server.port})
