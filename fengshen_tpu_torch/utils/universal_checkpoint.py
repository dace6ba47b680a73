"""UniversalCheckpoint: the port of
``fengshen_tpu/utils/universal_checkpoint.py`` (the checkpoint callback:
the same flags, ``save``, ``maybe_restore``, ``on_train_step_end`` and
``on_fit_end``) in a format of the port's own.

The reference writes orbax checkpoints; the port writes one directory
per step under ``--save_ckpt_path``::

    <save_ckpt_path>/<step>/
        meta.json               global_step, consumed_samples,
                                global_samples, the TrainState's step and
                                bad_step_count, the scheduler's position,
                                the optimizer's param groups and scalars
        params.safetensors      every parameter and buffer of the model
        optimizer.safetensors   the optimizer's state tensors (absent
                                under --save_weights_only)

A step is written under ``.tmp-<step>`` and committed by ``os.rename``;
the commit is verified by listing the directory again. Tensors are
written and read one at a time (the model on the card never passes
through host memory whole). ``--save_top_k`` keeps the newest steps
(-1: all). A save is idempotent per step.

A restore walks the steps newest to oldest: a step whose data cannot be
read (missing or truncated files) is rejected with a
``checkpoint_restore_rejected`` event and the next older one is tried;
in its own save directory the rejected steps are then deleted. A step
whose parameter names, shapes or dtypes differ from the model's raises
:class:`CheckpointStructureMismatch` at once, before any tensor is
read. A weights-only checkpoint loaded into a full run keeps the fresh
optimizer. A missing load path is skipped silently, as the reference
does. ``--async_save`` is not ported and raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Any, Optional

import torch

from fengshen_tpu_torch.models.llama.convert import (
    check_safetensors_complete, iter_safetensors, write_safetensors)

PARAMS_FILE = "params.safetensors"
OPTIMIZER_FILE = "optimizer.safetensors"
META_FILE = "meta.json"


class CheckpointStructureMismatch(ValueError):
    """The checkpoint's parameter names or shapes differ from the run's
    model: a configuration error (wrong model, wrong directory), not
    corrupt data, so no older step is tried."""


def committed_steps(path: str) -> list:
    """The committed steps under ``path`` (directories named by an
    integer), ascending; [] for a missing directory."""
    if not path or not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path)
                  if n.isdigit() and os.path.isdir(os.path.join(path, n)))


def latest_step(path: str) -> Optional[int]:
    steps = committed_steps(path)
    return steps[-1] if steps else None


def _state_entries(model: torch.nn.Module) -> dict:
    """Parameters and buffers by name (the tensors themselves)."""
    return dict(model.state_dict(keep_vars=True))


class UniversalCheckpoint:
    @staticmethod
    def add_argparse_args(parent_parser: argparse.ArgumentParser):
        """The reference's flags (:34-57, same names and defaults)."""
        parser = parent_parser.add_argument_group("universal checkpoint")
        parser.add_argument("--monitor", default="step", type=str)
        parser.add_argument("--mode", default="max", type=str)
        parser.add_argument("--save_ckpt_path", default="./ckpt/", type=str)
        parser.add_argument("--load_ckpt_path", default="./ckpt/", type=str)
        parser.add_argument("--filename", default="model-{step:02d}",
                            type=str)
        parser.add_argument("--save_last", action="store_true", default=False)
        parser.add_argument("--save_top_k", default=3, type=int)
        parser.add_argument("--every_n_train_steps", default=None, type=int)
        parser.add_argument("--save_weights_only", action="store_true",
                            default=False)
        parser.add_argument("--every_n_epochs", default=None, type=int)
        parser.add_argument("--save_on_train_epoch_end", action="store_true",
                            default=None)
        parser.add_argument("--async_save", action="store_true",
                            default=False,
                            help="not yet ported: saves are synchronous")
        return parent_parser

    def __init__(self, args):
        if getattr(args, "async_save", False):
            raise NotImplementedError(
                "--async_save is not yet ported in fengshen_tpu_torch "
                "(saves are synchronous)")
        self.args = args
        self.save_path = os.path.abspath(
            getattr(args, "save_ckpt_path", "./ckpt/"))
        self.load_path = getattr(args, "load_ckpt_path", None)
        every_n = getattr(args, "every_n_train_steps", None)
        self.every_n_train_steps = int(every_n) if every_n else 0
        #: saves and restores of this callback: counts, bytes, seconds
        self.stats = {"saves": 0, "bytes_written": 0, "save_s": 0.0,
                      "restores": 0, "bytes_read": 0, "restore_s": 0.0}

    # -- save ---------------------------------------------------------------
    def save(self, state: Any, trainer: Any, sync: bool = False) -> None:
        """Write the step ``trainer.global_step`` (``sync`` is accepted
        for the reference's signature: every save is synchronous). A
        step already committed is skipped; a commit that does not show
        in the directory afterwards raises."""
        del sync
        step = int(trainer.global_step)
        if step in committed_steps(self.save_path):
            return
        t0 = time.perf_counter()
        os.makedirs(self.save_path, exist_ok=True)
        tmp = os.path.join(self.save_path, f".tmp-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)          # left by a save that died
        os.makedirs(tmp)
        nbytes = write_safetensors(os.path.join(tmp, PARAMS_FILE),
                                   _state_entries(state.model))
        meta = {"global_step": step,
                "consumed_samples": int(trainer.consumed_samples),
                "global_samples": int(trainer.consumed_samples),
                **state.checkpoint_meta()}
        if not getattr(self.args, "save_weights_only", False):
            tensors, opt_meta = state.optimizer_payload()
            nbytes += write_safetensors(
                os.path.join(tmp, OPTIMIZER_FILE), tensors)
            meta["optimizer"] = opt_meta
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.save_path, str(step))
        os.rename(tmp, final)
        if step not in committed_steps(self.save_path) or \
                not os.path.exists(os.path.join(final, META_FILE)):
            raise RuntimeError(f"checkpoint step {step} did not commit "
                               f"under {self.save_path}")
        self._prune()
        self.stats["saves"] += 1
        self.stats["bytes_written"] += nbytes
        self.stats["save_s"] += time.perf_counter() - t0

    def _prune(self) -> None:
        top_k = getattr(self.args, "save_top_k", 3)
        if top_k in (-1, None):
            return
        steps = committed_steps(self.save_path)
        for old in steps[:max(len(steps) - max(int(top_k), 1), 0)]:
            shutil.rmtree(os.path.join(self.save_path, str(old)))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    # -- restore -------------------------------------------------------------
    @staticmethod
    def _check_structure(path: str, step: int, model) -> dict:
        """The step's params header, after checking it against the
        model: names, shapes and dtypes must agree."""
        header = check_safetensors_complete(
            os.path.join(path, str(step), PARAMS_FILE))
        from fengshen_tpu_torch.models.llama.convert import \
            SAFETENSORS_DTYPES
        want = {k: (tuple(v.shape), v.dtype)
                for k, v in _state_entries(model).items()}
        got = {k: (tuple(v["shape"]), SAFETENSORS_DTYPES.get(v["dtype"]))
               for k, v in header.items() if k != "__metadata__"}
        if want.keys() != got.keys():
            missing = sorted(want.keys() - got.keys())
            extra = sorted(got.keys() - want.keys())
            raise CheckpointStructureMismatch(
                f"step {step}: parameters missing {missing[:4]}, "
                f"unexpected {extra[:4]}")
        bad = [k for k in want if want[k] != got[k]]
        if bad:
            raise CheckpointStructureMismatch(
                f"step {step}: {bad[0]} is {got[bad[0]]} in the "
                f"checkpoint, {want[bad[0]]} in the model")
        return header

    def _restore_step(self, path: str, step: int, state: Any,
                      weights_only: bool) -> dict:
        """Load one step into ``state`` in place; raises on a missing or
        truncated file. What the checkpoint holds decides whether the
        optimizer is restored (a weights-only checkpoint keeps the fresh
        one)."""
        step_dir = os.path.join(path, str(step))
        with open(os.path.join(step_dir, META_FILE)) as f:
            meta = json.load(f)
        self._check_structure(path, step, state.model)
        opt_file = os.path.join(step_dir, OPTIMIZER_FILE)
        with_opt = not weights_only and "optimizer" in meta
        if with_opt:
            if meta["optimizer"]["param_names"] != state.param_names():
                raise CheckpointStructureMismatch(
                    f"step {step}: the optimizer holds other parameters "
                    "than this run's (other trainable modules?)")
            check_safetensors_complete(opt_file)
        entries = _state_entries(state.model)
        with torch.no_grad():
            for name, t in iter_safetensors(
                    os.path.join(step_dir, PARAMS_FILE)):
                entries[name].copy_(t)
        if with_opt:
            state.load_optimizer_payload(iter_safetensors(opt_file),
                                         meta["optimizer"])
        state.load_checkpoint_meta(meta, with_optimizer=with_opt)
        meta["_bytes_read"] = os.path.getsize(
            os.path.join(step_dir, PARAMS_FILE)) + (
            os.path.getsize(opt_file) if with_opt else 0)
        return meta

    def maybe_restore(self, state: Any, trainer: Any,
                      weights_only: bool = False) -> Any:
        """Restore the newest restorable step of ``--load_ckpt_path``
        into ``state`` (in place; returned) and set the trainer's
        ``global_step`` and ``consumed_samples``. A missing or empty
        path is skipped silently. ``weights_only`` restores the
        parameters alone (the eval entries)."""
        path = self.load_path
        if not path or not os.path.isdir(path):
            return state
        path = os.path.abspath(path)
        steps = committed_steps(path)[::-1]
        if not steps:
            return state
        log = getattr(trainer, "_log", None) or (lambda entry: None)
        t0 = time.perf_counter()
        meta, errors = None, []
        for step in steps:
            try:
                meta = self._restore_step(path, step, state, weights_only)
                break
            except CheckpointStructureMismatch:
                raise
            except Exception as e:  # noqa: BLE001 — a corrupt or partial
                # step: log it, fall back to the previous one
                errors.append((step, e))
                log({"event": "checkpoint_restore_rejected",
                     "ckpt_step": int(step),
                     "error": f"{type(e).__name__}: {str(e)[:200]}"})
        if meta is None:
            detail = "; ".join(f"step {s}: {type(e).__name__}: "
                               f"{str(e)[:120]}" for s, e in errors)
            raise RuntimeError(
                f"no restorable checkpoint under {path} ({detail})")
        if errors and path == self.save_path:
            # this run owns the directory: drop the unrestorable steps,
            # or a corrupt newest step would shadow every later save of
            # the same step number (saves are idempotent per step)
            for bad_step, _ in errors:
                shutil.rmtree(os.path.join(path, str(bad_step)),
                              ignore_errors=True)
                log({"event": "checkpoint_rejected_deleted",
                     "ckpt_step": int(bad_step)})
        trainer.global_step = int(meta["global_step"])
        trainer.consumed_samples = int(meta["consumed_samples"])
        self.stats["restores"] += 1
        self.stats["bytes_read"] += meta["_bytes_read"]
        self.stats["restore_s"] += time.perf_counter() - t0
        return state

    # -- trainer hooks --------------------------------------------------------
    def on_train_step_end(self, trainer: Any, state: Any) -> None:
        """Save when the step crossed a multiple of
        ``--every_n_train_steps`` (:322)."""
        if not self.every_n_train_steps:
            return
        prev = int(getattr(trainer, "prev_global_step",
                           trainer.global_step - 1))
        if (trainer.global_step // self.every_n_train_steps) > \
                (prev // self.every_n_train_steps):
            self.save(state, trainer)

    def on_fit_end(self, trainer: Any, state: Any) -> None:
        """Save at the end with ``--save_last`` or without
        ``--every_n_train_steps`` (:334)."""
        if getattr(self.args, "save_last", False) or \
                not self.every_n_train_steps:
            self.save(state, trainer, sync=True)
