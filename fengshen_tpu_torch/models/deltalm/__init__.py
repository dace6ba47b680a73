"""DeltaLM family (the port of ``fengshen_tpu/models/deltalm``): the
translation encoder-decoder with the interleaved decoder."""

from fengshen_tpu_torch.models.deltalm.modeling_deltalm import (
    DeltaLMConfig, DeltaLMForConditionalGeneration)

__all__ = ["DeltaLMConfig", "DeltaLMForConditionalGeneration"]
