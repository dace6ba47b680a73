"""Step guards: skip non-finite or spiking optimizer updates. The port of
``fengshen_tpu/resilience/guards.py``.

The reference decides inside the compiled step with ``lax.cond``; here
the decision is one device-to-host read of a boolean per step.
"""

from __future__ import annotations

import torch


def step_ok(metrics: dict, max_grad_norm: float = 0.0) -> torch.Tensor:
    """Boolean scalar: finite loss and finite global grad norm, and, with
    a positive ``max_grad_norm``, ``grad_norm <= max_grad_norm``."""
    ok = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
    if max_grad_norm and max_grad_norm > 0:
        ok = ok & (metrics["grad_norm"] <= max_grad_norm)
    return ok


def guarded_apply(state, ok: torch.Tensor):
    """Apply the update when ``ok``. Otherwise advance ``step`` and count
    ``bad_step_count``, leaving parameters, moments and the schedule's
    position untouched (the optax state does not advance on the
    reference's bad branch either), so a skipped step is exactly a no-op
    update."""
    if bool(ok):
        state.apply_gradients()
    else:
        state.step += 1
        state.bad_step_count += 1
    return state
