"""Resilience: the step guards so far (:mod:`.guards`)."""

from fengshen_tpu_torch.resilience.guards import guarded_apply, step_ok

__all__ = ["guarded_apply", "step_ok"]
