"""Standard post-LN BERT (the port of ``fengshen_tpu/models/bert``): the
encoder, the MLM head, the task heads and the HF and JAX weight maps."""

from fengshen_tpu_torch.models.bert.modeling_bert import (BertConfig,
                                                          BertForMaskedLM,
                                                          BertLayer,
                                                          BertModel)
from fengshen_tpu_torch.models.bert.task_heads import (
    BertForMultipleChoice, BertForQuestionAnswering,
    BertForSequenceClassification, BertForTokenClassification)

__all__ = ["BertConfig", "BertLayer", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertForTokenClassification",
           "BertForQuestionAnswering", "BertForMultipleChoice"]
