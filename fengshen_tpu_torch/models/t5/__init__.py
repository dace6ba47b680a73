"""T5 / Randeng family (the port of ``fengshen_tpu/models/t5``): the
encoder-decoder, its heads, the HF and JAX weight maps and the
char-level T5 tokenizer."""

from fengshen_tpu_torch.models.t5.configuration_t5 import T5Config
from fengshen_tpu_torch.models.t5.modeling_t5 import (
    T5EncoderModel, T5ForConditionalGeneration, T5Model)
from fengshen_tpu_torch.models.t5.tokenization_megatron_t5 import \
    T5Tokenizer

__all__ = ["T5Config", "T5Model", "T5ForConditionalGeneration",
           "T5EncoderModel", "T5Tokenizer"]
