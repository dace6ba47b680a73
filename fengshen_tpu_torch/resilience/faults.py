"""Deterministic fault injection for the Trainer's resilience paths.
The port's copy of ``fengshen_tpu/resilience/faults.py``.

A :class:`FaultPlan` says when faults fire, in step and batch
coordinates, and installs through the Trainer's hooks:

- ``nan_loss_at_steps``: the grad step makes the loss NaN when the
  (0-based) ``TrainState.step`` is one of these, so the step guard
  skips that update exactly as it would a real blow-up;
- ``sigterm_at_step``: a real ``SIGTERM`` to this process (``os.kill``)
  when ``trainer.global_step`` crosses the value, driving the handler,
  the synchronous save and the clean return;
- ``loader_raise_at``: ``{batch index: times}``; ``wrap_datamodule``
  makes the train loader raise ``InjectedLoaderFault`` that many times
  before yielding that batch (a failed attempt consumes no sample);
- :func:`truncate_checkpoint_step` removes payload files of a committed
  checkpoint step, which ``maybe_restore`` must reject and fall back
  from.

After a rewind the Trainer replays the same step numbers; with
``clear_nan_on_rewind`` (default) the plan disarms its NaN steps and the
Trainer rebuilds its grad step without them.
"""

from __future__ import annotations

import os
import signal
from typing import Any, Iterable, Optional


class InjectedLoaderFault(IOError):
    """Marker exception for injected loader failures."""


class FaultPlan:
    def __init__(self, nan_loss_at_steps: Iterable[int] = (),
                 sigterm_at_step: Optional[int] = None,
                 loader_raise_at: Optional[dict] = None,
                 clear_nan_on_rewind: bool = True):
        self.nan_loss_at_steps = frozenset(
            int(s) for s in nan_loss_at_steps)
        self.sigterm_at_step = sigterm_at_step
        self.loader_raise_at = dict(loader_raise_at or {})
        self.clear_nan_on_rewind = clear_nan_on_rewind
        self.fired: list = []

    # -- installation ---------------------------------------------------
    def install(self, trainer: Any) -> "FaultPlan":
        """Arm the plan on a Trainer: NaN injection is read by the step
        builder from `trainer.fault_plan`; SIGTERM delivery rides the
        ordinary callback hook."""
        trainer.fault_plan = self
        trainer.callbacks.append(self)
        return self

    def wrap_datamodule(self, datamodule: Any) -> Any:
        """Make `train_dataloader()` return fault-injecting loaders.
        The raise budget lives on the PLAN (shared dict), so it spans
        the several loader instances `fit` creates."""
        orig = datamodule.train_dataloader

        def wrapped():
            return FaultyLoader(orig(), self.loader_raise_at)

        datamodule.train_dataloader = wrapped
        return datamodule

    # -- trainer hook ---------------------------------------------------
    def on_train_step_end(self, trainer: Any, state: Any) -> None:
        t = self.sigterm_at_step
        if t is None:
            return
        prev = int(getattr(trainer, "prev_global_step",
                           trainer.global_step - 1))
        if prev < t <= trainer.global_step:
            self.sigterm_at_step = None
            self.fired.append(("sigterm", int(trainer.global_step)))
            os.kill(os.getpid(), signal.SIGTERM)

    def disarm_nan(self) -> None:
        self.fired.append(("nan_disarmed", sorted(self.nan_loss_at_steps)))
        self.nan_loss_at_steps = frozenset()


class FaultyLoader:
    """Loader wrapper raising `InjectedLoaderFault` at planned batches.

    `raise_at` maps a cumulative successful-batch index to the number
    of times pulling that batch fails; the dict is mutated in place so
    the budget is shared with the owning `FaultPlan` across loader
    re-creation. The raise happens BEFORE the underlying loader is
    advanced: a failed attempt consumes no samples.
    """

    def __init__(self, loader: Any, raise_at: dict):
        self.loader = loader
        self.raise_at = raise_at
        self._yielded = 0

    def __getattr__(self, name: str):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def skip_next(self) -> None:
        """ResilientLoader's cooperative skip protocol: advance past the
        next (poison) batch without yielding it — delegating to the
        wrapped loader's own skip (which advances WITHOUT fetching)
        when it has one."""
        self._yielded += 1
        skip = getattr(self.loader, "skip_next", None)
        if callable(skip):
            skip()
        else:
            next(iter(self.loader), None)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            idx = self._yielded
            if self.raise_at.get(idx, 0) > 0:
                self.raise_at[idx] -= 1
                raise InjectedLoaderFault(
                    f"injected loader fault at batch {idx}")
            try:
                batch = next(it)
            except StopIteration:
                return
            self._yielded += 1
            yield batch


def truncate_checkpoint_step(ckpt_path: str, step: int) -> list:
    """Corrupt a committed checkpoint step of ``UniversalCheckpoint``
    in place: remove the largest half of its files (the tensor payloads
    first), leaving a committed-looking step that cannot be restored.
    Returns the removed paths; raises if the step does not exist."""
    root = os.path.join(ckpt_path, str(int(step)))
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no step-{step} checkpoint directory under {ckpt_path}")
    files = []
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            p = os.path.join(dirpath, fn)
            files.append((os.path.getsize(p), p))
    if not files:
        raise FileNotFoundError(f"step-{step} checkpoint {root} is empty")
    files.sort(reverse=True)
    removed = []
    for _, p in files[:max(1, len(files) // 2)]:
        os.remove(p)
        removed.append(p)
    return removed
