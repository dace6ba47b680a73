"""GPT-2 / Wenzhong family (the port of ``fengshen_tpu/models/gpt2``):
the decoder, its tied LM head and the HF and JAX weight maps."""

from fengshen_tpu_torch.models.gpt2.configuration_gpt2 import GPT2Config
from fengshen_tpu_torch.models.gpt2.modeling_gpt2 import (GPT2LMHeadModel,
                                                          GPT2Model)

__all__ = ["GPT2Config", "GPT2Model", "GPT2LMHeadModel"]
