"""Megatron-style indexed corpora (the port of
``fengshen_tpu/data/megatron_dataloader``): the ``.idx`` + ``.bin``
token store and the BART denoising dataset over it. ``BertDataset``,
``GPTDataset``, ``BlendableDataset`` and the native index helpers are
not yet ported (ROADMAP.md queue 1 item 11)."""

from fengshen_tpu_torch.data.megatron_dataloader.bart_dataset import \
    BartDataset
from fengshen_tpu_torch.data.megatron_dataloader.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)

__all__ = ["MMapIndexedDataset", "MMapIndexedDatasetBuilder",
           "BartDataset"]
