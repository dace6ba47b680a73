"""BART family (the port of ``fengshen_tpu/models/bart``): the
encoder-decoder, its seq2seq and text-infill heads, and the HF and JAX
weight maps."""

from fengshen_tpu_torch.models.bart.modeling_bart import (
    BartConfig, BartForConditionalGeneration, BartForTextInfill, BartModel,
    text_infill_loss)

__all__ = ["BartConfig", "BartModel", "BartForConditionalGeneration",
           "BartForTextInfill", "text_infill_loss"]
