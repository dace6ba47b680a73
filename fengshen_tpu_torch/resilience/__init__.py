"""Resilience: step guards, retrying loaders and deterministic fault
injection (the port of ``fengshen_tpu/resilience``). The Trainer wires
them: guards and rewinds in its loop, :class:`ResilientLoader` around
its loaders, corrupt-step fallback in ``UniversalCheckpoint``."""

from fengshen_tpu_torch.resilience.faults import (FaultPlan, FaultyLoader,
                                                  InjectedLoaderFault,
                                                  truncate_checkpoint_step)
from fengshen_tpu_torch.resilience.guards import guarded_apply, step_ok
from fengshen_tpu_torch.resilience.loader import ResilientLoader

__all__ = ["guarded_apply", "step_ok", "ResilientLoader", "FaultPlan",
           "FaultyLoader", "InjectedLoaderFault",
           "truncate_checkpoint_step"]
