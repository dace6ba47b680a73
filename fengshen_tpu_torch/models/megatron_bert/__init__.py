"""MegatronBert / Erlangshen family (the port of
``fengshen_tpu/models/megatron_bert``): pre-LN encoder, its heads and
the HF and JAX weight maps."""

from fengshen_tpu_torch.models.megatron_bert.configuration_megatron_bert \
    import MegatronBertConfig
from fengshen_tpu_torch.models.megatron_bert.modeling_megatron_bert import (
    MegatronBertForMaskedLM, MegatronBertForPreTraining,
    MegatronBertForSequenceClassification,
    MegatronBertForTokenClassification, MegatronBertModel, MLMHead)
from fengshen_tpu_torch.models.megatron_bert.task_heads import (
    MegatronBertForMultipleChoice, MegatronBertForQuestionAnswering)

__all__ = ["MegatronBertConfig", "MegatronBertModel", "MLMHead",
           "MegatronBertForPreTraining", "MegatronBertForMaskedLM",
           "MegatronBertForSequenceClassification",
           "MegatronBertForTokenClassification",
           "MegatronBertForQuestionAnswering",
           "MegatronBertForMultipleChoice"]
