"""Train state: the port of ``fengshen_tpu/trainer/train_state.py:16``.

The reference's state is an immutable pytree (step, params, optimizer
state); here the parameters live in the model, the moments in the
optimizer, the schedule's position in the scheduler, and the state
holds them with ``step`` and ``bad_step_count``. Updates happen in
place. :meth:`checkpoint_meta` and :meth:`optimizer_payload` are what a
checkpoint (``utils/universal_checkpoint.py``) keeps beside the
parameters, and their ``load_*`` counterparts put them back.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class TrainState:
    """Step counter, the model (its parameters), optimizer and
    scheduler."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, scheduler,
                 gradient_clip_val: Optional[float] = None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.gradient_clip_val = gradient_clip_val or 0.0
        self.step = 0
        #: updates skipped by the step guard (non-finite loss or grads,
        #: or a grad-norm spike)
        self.bad_step_count = 0

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in ``.grad``: clip by global
        norm where configured, AdamW, advance the schedule and ``step``."""
        if self.gradient_clip_val:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                           self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return self

    @classmethod
    def create(cls, model, optimizer, scheduler,
               gradient_clip_val: Optional[float] = None) -> "TrainState":
        return cls(model, optimizer, scheduler, gradient_clip_val)

    # -- checkpoint ------------------------------------------------------
    def checkpoint_meta(self) -> dict:
        """``bad_step_count`` and the scheduler's position (``step`` is
        the checkpoint's ``global_step``)."""
        return {"bad_step_count": int(self.bad_step_count),
                "scheduler": {"last_epoch": int(self.scheduler.last_epoch),
                              "step_count": int(getattr(
                                  self.scheduler, "_step_count", 0)),
                              "last_lr": [float(x) for x in getattr(
                                  self.scheduler, "_last_lr", [])]}}

    def load_checkpoint_meta(self, meta: dict,
                             with_optimizer: bool = True) -> None:
        """``step`` from the checkpoint's ``global_step`` and, with the
        optimizer's state, ``bad_step_count`` and the scheduler's
        position. A weights-only checkpoint leaves the fresh optimizer
        and its schedule at 0, as the reference's fresh optax state
        does."""
        self.step = int(meta["global_step"])
        if not with_optimizer:
            return
        self.bad_step_count = int(meta.get("bad_step_count", 0))
        sched = meta["scheduler"]
        self.scheduler.last_epoch = int(sched["last_epoch"])
        self.scheduler._step_count = int(sched["step_count"])
        if sched["last_lr"]:
            self.scheduler._last_lr = list(sched["last_lr"])

    def param_names(self) -> list:
        """Names of the optimizer's parameters in its state-dict order."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def optimizer_payload(self) -> tuple[dict, dict]:
        """``(tensors, meta)``: the optimizer's state tensors named
        ``<index>/<key>``, and a JSON-able meta of its param groups,
        its non-tensor state values and each index's parameter name."""
        sd = self.optimizer.state_dict()
        tensors, scalars = {}, {}
        for idx, st in sd["state"].items():
            for key, value in st.items():
                if torch.is_tensor(value):
                    tensors[f"{idx}/{key}"] = value
                else:
                    scalars[f"{idx}/{key}"] = value
        return tensors, {"param_groups": sd["param_groups"],
                         "scalars": scalars,
                         "param_names": self.param_names()}

    def load_optimizer_payload(self, tensors: Iterable[tuple],
                               meta: dict) -> None:
        """Load what :meth:`optimizer_payload` saved; each tensor goes to
        its parameter's device as it is read (0-d tensors, such as
        ``torch.optim.AdamW``'s step counts, stay on the CPU); ``meta``'s
        ``param_names`` must be :meth:`param_names`."""
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        state: dict = {}
        for key, value in tensors:
            idx, name = key.split("/", 1)
            if value.dim():
                value = value.to(params[int(idx)].device)
            state.setdefault(int(idx), {})[name] = value
        for key, value in meta["scalars"].items():
            idx, name = key.split("/", 1)
            state.setdefault(int(idx), {})[name] = value
        self.optimizer.load_state_dict(
            {"state": state, "param_groups": meta["param_groups"]})
