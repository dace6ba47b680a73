"""Megatron-style indexed corpora (the port of
``fengshen_tpu/data/megatron_dataloader``): the ``.idx`` + ``.bin``
token store, the host C++ index builders (``helpers``), and the
datasets over them: BERT MLM + sentence order, GPT packing, BART
denoising, and weighted blending."""

from fengshen_tpu_torch.data.megatron_dataloader.bart_dataset import \
    BartDataset
from fengshen_tpu_torch.data.megatron_dataloader.bert_dataset import \
    BertDataset
from fengshen_tpu_torch.data.megatron_dataloader.blendable_dataset import \
    BlendableDataset
from fengshen_tpu_torch.data.megatron_dataloader.gpt_dataset import \
    GPTDataset
from fengshen_tpu_torch.data.megatron_dataloader.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)

__all__ = ["MMapIndexedDataset", "MMapIndexedDatasetBuilder",
           "BlendableDataset", "GPTDataset", "BertDataset", "BartDataset"]
