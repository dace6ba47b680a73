"""Pegasus family (the port of ``fengshen_tpu/models/pegasus``)."""

from fengshen_tpu_torch.models.pegasus.modeling_pegasus import (
    PegasusConfig, PegasusForConditionalGeneration)

__all__ = ["PegasusConfig", "PegasusForConditionalGeneration"]
