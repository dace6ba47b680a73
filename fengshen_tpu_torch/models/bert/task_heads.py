"""The task heads over BERT (the port of
``fengshen_tpu/models/bert/task_heads.py``), from the shared factory in
``models/heads.py``."""

from fengshen_tpu_torch.models.bert.modeling_bert import BertModel
from fengshen_tpu_torch.models.heads import make_task_heads

(_SeqCls, _TokCls, _QA, _MC) = make_task_heads(
    BertModel, encoder_name="bert")

BertForSequenceClassification = _SeqCls
BertForSequenceClassification.__name__ = "BertForSequenceClassification"
BertForTokenClassification = _TokCls
BertForTokenClassification.__name__ = "BertForTokenClassification"
BertForQuestionAnswering = _QA
BertForQuestionAnswering.__name__ = "BertForQuestionAnswering"
BertForMultipleChoice = _MC
BertForMultipleChoice.__name__ = "BertForMultipleChoice"

__all__ = ["BertForSequenceClassification", "BertForTokenClassification",
           "BertForQuestionAnswering", "BertForMultipleChoice"]
