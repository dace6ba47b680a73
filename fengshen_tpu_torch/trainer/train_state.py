"""Train state: the port of ``fengshen_tpu/trainer/train_state.py:16``.

The reference's state is an immutable pytree (step, params, optimizer
state); here the parameters live in the model, the moments in the
optimizer, the schedule's position in the scheduler, and the state
holds them with ``step`` and ``bad_step_count``. Updates happen in
place.
"""

from __future__ import annotations

from typing import Optional

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
