"""Sample-construction utilities (the port of
``fengshen_tpu/data/data_utils``): the whole-word grouping the BART
denoising dataset uses. The masked-LM and sentence-order helpers wait
for the BERT pretraining examples (ROADMAP.md queue 1 item 11)."""

from fengshen_tpu_torch.data.data_utils.mask_utils import (is_start_piece,
                                                           whole_word_spans)

__all__ = ["is_start_piece", "whole_word_spans"]
