"""T5 span-corruption pretraining data (the port of
``fengshen_tpu/data/t5_dataloader``). ``DialogCollator`` is not yet
ported: no ported example uses it."""

from fengshen_tpu_torch.data.t5_dataloader.t5_datasets import (
    T5SpanCorruptionCollator, compute_input_and_target_lengths,
    random_spans_noise_mask)

__all__ = ["compute_input_and_target_lengths", "random_spans_noise_mask",
           "T5SpanCorruptionCollator"]
