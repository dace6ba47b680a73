"""Question answering and multiple choice over MegatronBert (the port of
``fengshen_tpu/models/megatron_bert/task_heads.py``), from the shared
factory in ``models/heads.py``."""

from fengshen_tpu_torch.models.heads import make_task_heads
from fengshen_tpu_torch.models.megatron_bert.modeling_megatron_bert import (
    MegatronBertModel)

(_SeqCls, _TokCls, _QA, _MC) = make_task_heads(
    MegatronBertModel, encoder_name="bert")

MegatronBertForQuestionAnswering = _QA
MegatronBertForQuestionAnswering.__name__ = "MegatronBertForQuestionAnswering"
MegatronBertForMultipleChoice = _MC
MegatronBertForMultipleChoice.__name__ = "MegatronBertForMultipleChoice"

__all__ = ["MegatronBertForQuestionAnswering", "MegatronBertForMultipleChoice"]
