"""Sample-construction utilities (the port of
``fengshen_tpu/data/data_utils``): sentence splitting, sentence-order
pairing, truncation, ``[CLS]``/``[SEP]`` assembly, whole-word grouping
and masked-LM predictions, each drawing from the caller's
``numpy.random.RandomState`` in the JAX package's order."""

from fengshen_tpu_torch.data.data_utils.mask_utils import (
    MaskedLmInstance, create_masked_lm_predictions, is_start_piece,
    whole_word_spans)
from fengshen_tpu_torch.data.data_utils.sentence_split import \
    ChineseSentenceSplitter
from fengshen_tpu_torch.data.data_utils.sop_utils import \
    get_a_and_b_segments
from fengshen_tpu_torch.data.data_utils.token_type_utils import \
    create_tokens_and_tokentypes
from fengshen_tpu_torch.data.data_utils.truncate_utils import \
    truncate_segments

__all__ = ["ChineseSentenceSplitter", "get_a_and_b_segments",
           "truncate_segments", "create_tokens_and_tokentypes",
           "create_masked_lm_predictions", "MaskedLmInstance",
           "is_start_piece", "whole_word_spans"]
