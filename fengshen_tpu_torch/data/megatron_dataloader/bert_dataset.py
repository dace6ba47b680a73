"""BERT-style MLM + sentence-order samples over an indexed corpus: the
port of ``fengshen_tpu/data/megatron_dataloader/bert_dataset.py``
(:25-94).

The windows come from :func:`..helpers.build_mapping` over the corpus's
documents and sentences (two or more whole sentences each, targets of
``max_seq_length - 3`` tokens, shortened with ``short_seq_prob``). Sample
``i`` draws from ``RandomState(seed + i)``: the sentence-order pair, the
truncation, ``[CLS] A [SEP] B [SEP]`` and whole-word MLM, padded to
``max_seq_length`` with labels -100 off the masked positions; so it is
the JAX package's bitwise.

Word units come from ``zh_tokenizer``: ``None`` means ``jieba.lcut``
and raises ``ImportError`` where ``jieba`` is not installed, ``False``
groups wordpieces by their ``##`` prefix, a callable segments the text
itself. (The JAX package falls back to the wordpiece grouping when
``jieba`` does not import, :41-47.)
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.data.data_utils import (create_masked_lm_predictions,
                                                create_tokens_and_tokentypes,
                                                get_a_and_b_segments,
                                                truncate_segments)
from fengshen_tpu_torch.data.data_utils.mask_utils import jieba_lcut
from fengshen_tpu_torch.data.megatron_dataloader.helpers import build_mapping
from fengshen_tpu_torch.data.megatron_dataloader.indexed_dataset import (
    MMapIndexedDataset)


class BertDataset:
    """Samples ``{input_ids, attention_mask, token_type_ids, labels}``
    (``int32 [max_seq_length]`` each) and ``next_sentence_label``
    (``int32 []``, 1 when the pair was swapped)."""

    def __init__(self, indexed: MMapIndexedDataset, tokenizer: Any,
                 max_seq_length: int = 512, masked_lm_prob: float = 0.15,
                 short_seq_prob: float = 0.1, seed: int = 0,
                 zh_tokenizer: Optional[Any] = None):
        self.indexed = indexed
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.masked_lm_prob = masked_lm_prob
        self.seed = seed
        if zh_tokenizer is None:
            zh_tokenizer = jieba_lcut("BertDataset")
        self.zh_tokenizer = zh_tokenizer or None
        self.samples_mapping = build_mapping(
            np.asarray(indexed.doc_idx, np.int64),
            np.asarray(indexed.sizes, np.int32), max_seq_length - 3,
            short_seq_prob, seed)
        vocab = tokenizer.get_vocab()
        self.vocab_id_list = list(vocab.values())
        self.vocab_id_to_token = {v: k for k, v in vocab.items()}

    def __len__(self) -> int:
        return len(self.samples_mapping)

    def __getitem__(self, idx: int) -> dict:
        start, end, target_len = (int(x) for x in self.samples_mapping[idx])
        sents = [np.asarray(self.indexed[i]).tolist()
                 for i in range(start, end)]
        np_rng = np.random.RandomState((self.seed + idx) % (2 ** 31))
        tok = self.tokenizer

        a, b, is_random = get_a_and_b_segments(sents, np_rng)
        truncate_segments(a, b, len(a), len(b), target_len, np_rng)
        tokens, tokentypes = create_tokens_and_tokentypes(
            a, b, tok.cls_token_id, tok.sep_token_id)
        masked_tokens, positions, labels = create_masked_lm_predictions(
            tokens, self.vocab_id_list, self.vocab_id_to_token,
            self.masked_lm_prob, tok.cls_token_id, tok.sep_token_id,
            tok.mask_token_id,
            max_predictions_per_seq=int(
                self.masked_lm_prob * self.max_seq_length) + 1,
            np_rng=np_rng, zh_tokenizer=self.zh_tokenizer)

        mlm_labels = [-100] * len(tokens)
        for pos, label in zip(positions, labels):
            mlm_labels[pos] = label
        pad_id = tok.pad_token_id or 0
        pad = self.max_seq_length - len(masked_tokens)
        return {
            "input_ids": np.asarray(masked_tokens + [pad_id] * pad,
                                    np.int32),
            "attention_mask": np.asarray(
                [1] * len(masked_tokens) + [0] * pad, np.int32),
            "token_type_ids": np.asarray(tokentypes + [0] * pad, np.int32),
            "labels": np.asarray(mlm_labels + [-100] * pad, np.int32),
            "next_sentence_label": np.asarray(int(is_random), np.int32),
        }
