"""DeBERTa-v2 family (the port of ``fengshen_tpu/models/deberta_v2``, the
Erlangshen-DeBERTa-v2 encoders): disentangled attention over
log-bucketed relative positions, the MLM and classification heads, the
task heads and the HF and JAX weight maps."""

from fengshen_tpu_torch.models.deberta_v2.modeling_deberta_v2 import (
    DebertaV2Config, DebertaV2ForMaskedLM,
    DebertaV2ForSequenceClassification, DebertaV2Model,
    build_relative_position, make_log_bucket_position)
from fengshen_tpu_torch.models.deberta_v2.task_heads import (
    DebertaV2ForMultipleChoice, DebertaV2ForQuestionAnswering,
    DebertaV2ForTokenClassification)

__all__ = ["DebertaV2Config", "DebertaV2Model", "DebertaV2ForMaskedLM",
           "DebertaV2ForSequenceClassification",
           "DebertaV2ForTokenClassification",
           "DebertaV2ForQuestionAnswering", "DebertaV2ForMultipleChoice",
           "build_relative_position", "make_log_bucket_position"]
