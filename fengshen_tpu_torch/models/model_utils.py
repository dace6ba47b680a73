"""Optimizer and LR-schedule factory and the shared argparse group: the
port of ``fengshen_tpu/models/model_utils.py``.

- :func:`add_module_args` (:26): the same flag names and defaults.
- :func:`decay_mask_fn` (:59): no weight decay for biases, norms and
  any parameter of fewer than two dimensions.
- :func:`get_scheduler` (:75): the same schedules, as plain functions of
  the optimizer step (the reference builds them from optax).
- :func:`configure_optimizers` (:122): AdamW (``torch.optim.AdamW`` for
  fp32 parameters; :class:`AdamW`, ``optax.adamw``'s update op for op in
  each parameter's dtype, when any parameter is in a lower precision)
  with a decay and a no-decay parameter group from :func:`decay_mask_fn`,
  and a ``LambdaLR`` that sets the learning rate to ``schedule(step)``
  (the groups' base rate is 1, so the rate is the schedule's value
  exactly). As in optax,
  update ``n`` (from 0) uses ``schedule(n)``. Gradient clipping
  (``--gradient_clip_val``) is applied by the train state before the
  update, as the reference chains ``clip_by_global_norm`` before AdamW.
- :func:`get_total_steps` (:152).
"""

from __future__ import annotations

import argparse
import math
from typing import Callable

import torch
from torch.optim.lr_scheduler import LambdaLR

Schedule = Callable[[int], float]


def add_module_args(parent_parser: argparse.ArgumentParser):
    """The reference's "Basic Module" flag group (same names)."""
    parser = parent_parser.add_argument_group("Basic Module")
    parser.add_argument("--learning_rate", default=5e-5, type=float)
    parser.add_argument("--min_learning_rate", default=1e-7, type=float)
    parser.add_argument("--lr_decay_steps", default=0, type=int)
    parser.add_argument("--lr_decay_ratio", default=1.0, type=float)
    parser.add_argument("--warmup_steps", default=0, type=int)
    parser.add_argument("--warmup_ratio", default=0.1, type=float)
    parser.add_argument("--weight_decay", default=1e-1, type=float)
    parser.add_argument("--adam_beta1", default=0.9, type=float)
    parser.add_argument("--adam_beta2", default=0.999, type=float)
    parser.add_argument("--adam_epsilon", default=1e-8, type=float)
    parser.add_argument("--model_path", default=None, type=str)
    parser.add_argument(
        "--scheduler_type", default="polynomial", type=str,
        choices=["polynomial", "constant", "cosine", "inverse_sqrt",
                 "constant_with_warmup", "direct"])
    return parent_parser


NO_DECAY_PATTERNS = ("bias", "scale", "layernorm", "layer_norm", "ln_",
                     "norm")


def decay_mask_fn(model: torch.nn.Module) -> dict:
    """``{parameter name: True where weight decay applies}``."""
    def keep(name: str, p: torch.Tensor) -> bool:
        low = name.lower()
        if any(pat in low for pat in NO_DECAY_PATTERNS):
            return False
        return p.dim() >= 2

    return {name: keep(name, p) for name, p in model.named_parameters()}


# -- schedules (optax's formulas, as functions of the update count) --------

def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda step: init
    return lambda step: (init - end) * (
        1.0 - min(max(step, 0), steps) / steps) + end


def _polynomial(init: float, end: float, power: float,
                steps: int) -> Schedule:
    if steps <= 0:
        return lambda step: init
    return lambda step: (init - end) * (
        1.0 - min(max(step, 0), steps) / steps) ** power + end


def _join(schedules: list, boundaries: list) -> Schedule:
    def schedule(step: int) -> float:
        offset = 0
        for fn, bound in zip(schedules, boundaries):
            if step < bound:
                return fn(step - offset)
            offset = bound
        return schedules[-1](step - offset)

    return schedule


def _cosine_decay(init: float, steps: int, alpha: float) -> Schedule:
    if steps <= 0:
        raise ValueError("the cosine schedule needs positive decay steps, "
                         f"got {steps}")

    def schedule(step: int) -> float:
        count = min(max(step, 0), steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def get_scheduler(args, total_steps: int) -> Schedule:
    """LR schedule factory; ``warmup_steps`` wins over ``warmup_ratio``."""
    lr = args.learning_rate
    warmup = args.warmup_steps if args.warmup_steps > 0 else int(
        args.warmup_ratio * total_steps)
    decay_steps = args.lr_decay_steps if getattr(
        args, "lr_decay_steps", 0) > 0 else total_steps
    stype = getattr(args, "scheduler_type", "polynomial")

    if stype == "direct":
        return lambda step: lr
    if stype in ("constant", "constant_with_warmup"):
        return _join([_linear(0.0, lr, max(warmup, 1)), lambda step: lr],
                     [warmup])
    if stype == "cosine":
        end = getattr(args, "min_learning_rate", 0.0)
        alpha = end / lr if lr != 0 else 0.0
        return _join([_linear(0.0, lr, warmup),
                      _cosine_decay(lr, decay_steps - warmup, alpha)],
                     [warmup])
    if stype == "inverse_sqrt":
        warmup_min = getattr(args, "warmup_min_lr", 1e-9)
        warmup_max = getattr(args, "warmup_max_lr", lr)

        def inv_sqrt(step: int) -> float:
            w = max(warmup, 1)
            if step < w:
                return warmup_min + (warmup_max - warmup_min) * (step / w)
            return warmup_max * (w ** 0.5) / (max(step, 1) ** 0.5)

        return inv_sqrt
    end_lr = getattr(args, "min_learning_rate", 0.0)
    return _join([_linear(0.0, lr, max(warmup, 1)),
                  _polynomial(lr, end_lr, 1.0,
                              max(decay_steps - warmup, 1))],
                 [warmup])


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``, ``apply_updates``) as the JAX trainer runs
    it, for parameters of any float dtype.

    optax keeps both moments in the parameter's dtype and computes every
    elementary step in it, its Python-float constants cast to that dtype
    (``b1`` of 0.9 is 0.8984375 in bf16). So does this optimizer: for
    bf16 parameters each product, sum, quotient and square root below is
    rounded to bf16, in optax's order, and the result matches optax's
    bitwise on the CPU; in fp32 it is optax's fp32 arithmetic.
    ``torch.optim.AdamW`` decays the parameter first and folds the bias
    corrections into one step size, which rounds otherwise in bf16.
    ``lr`` is the schedule's value for this update; weight decay applies
    to the groups that set it."""

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def _const(x: float, dtype: torch.dtype) -> float:
        """``x`` as optax sees it beside an array of ``dtype``: rounded
        to fp32, then to ``dtype``."""
        return float(torch.tensor(x, dtype=torch.float32).to(dtype))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                count = state["step"]

                def c(x, dt=p.dtype):
                    return self._const(x, dt)

                g, mu, nu = p.grad, state["exp_avg"], state["exp_avg_sq"]
                # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
                mu.mul_(c(b1)).add_(g.mul(c(1 - b1)))
                nu.mul_(c(b2)).add_((g * g).mul_(c(1 - b2)))
                # bias corrections in fp32, then in the moments' dtype
                bc1 = c(float(1 - torch.tensor(b1) ** count))
                bc2 = c(float(1 - torch.tensor(b2) ** count))
                upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(c(
                    group["eps"])))
                if group["weight_decay"]:
                    upd.add_(p.mul(c(group["weight_decay"])))
                p.add_(upd.mul_(c(-float(group["lr"]))))
        return None


def configure_optimizers(args, total_steps: int,
                         model: torch.nn.Module
                         ) -> tuple[torch.optim.Optimizer, LambdaLR]:
    """``(AdamW, LambdaLR)`` over ``model``'s trainable parameters (a
    frozen one, as LoRA's base, gets no moments); the scheduler's
    ``schedule`` attribute is the schedule function itself.

    With every parameter in fp32 the optimizer is ``torch.optim.AdamW``:
    in fp32 it agrees with optax to ~1e-8 and reads and writes each
    parameter's state in about half the passes of :class:`AdamW`'s
    op-by-op form. Parameters in a lower precision take :class:`AdamW`,
    whose rounding is optax's."""
    schedule = get_scheduler(args, total_steps)
    mask = decay_mask_fn(model)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": getattr(args, "weight_decay", 0.0)},
        {"params": [p for n, p in params.items() if not mask[n]],
         "weight_decay": 0.0},
    ]
    fp32 = all(p.dtype == torch.float32 for p in params.values())
    optimizer = (torch.optim.AdamW if fp32 else AdamW)(
        [g for g in groups if g["params"]], lr=1.0,
        betas=(getattr(args, "adam_beta1", 0.9),
               getattr(args, "adam_beta2", 0.999)),
        eps=getattr(args, "adam_epsilon", 1e-8))
    scheduler = LambdaLR(optimizer, schedule)
    scheduler.schedule = schedule
    return optimizer, scheduler


def get_total_steps(args, dataset_len: int, world_batch: int) -> int:
    """Total optimizer steps."""
    if getattr(args, "max_steps", 0) and args.max_steps > 0:
        return args.max_steps
    epochs = getattr(args, "max_epochs", 1) or 1
    return max(1, epochs * dataset_len // max(world_batch, 1))
