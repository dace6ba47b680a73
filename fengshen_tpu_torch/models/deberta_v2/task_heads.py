"""The task heads over DeBERTa-v2 (the port of
``fengshen_tpu/models/deberta_v2/task_heads.py``), from the shared
factory in ``models/heads.py``: the encoder has no pooler, so the
sequence-classification and multiple-choice heads pool ``[CLS]``
through a ``pooler`` projection and tanh of their own."""

from fengshen_tpu_torch.models.deberta_v2.modeling_deberta_v2 import \
    DebertaV2Model
from fengshen_tpu_torch.models.heads import make_task_heads

(_SeqCls, _TokCls, _QA, _MC) = make_task_heads(
    DebertaV2Model, has_pooler=False, encoder_name="deberta")

DebertaV2ForTokenClassification = _TokCls
DebertaV2ForTokenClassification.__name__ = "DebertaV2ForTokenClassification"
DebertaV2ForQuestionAnswering = _QA
DebertaV2ForQuestionAnswering.__name__ = "DebertaV2ForQuestionAnswering"
DebertaV2ForMultipleChoice = _MC
DebertaV2ForMultipleChoice.__name__ = "DebertaV2ForMultipleChoice"

__all__ = ["DebertaV2ForTokenClassification",
           "DebertaV2ForQuestionAnswering", "DebertaV2ForMultipleChoice"]
