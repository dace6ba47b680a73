"""BART text-infilling samples over an indexed corpus: the port of
``fengshen_tpu/data/megatron_dataloader/bart_dataset.py``.

Each document of a :class:`..indexed_dataset.MMapIndexedDataset` (its
sentences joined behind ``[CLS]``, each ended by ``[SEP]``, cut to
``max_seq_length``) becomes one sample: the clean tokens after
``[CLS]`` are the labels; the source has its sentences permuted
(``[CLS]`` kept first) and whole-word spans of Poisson(3) words, about
twice ``masked_lm_prob`` of the candidate tokens, each collapsed to one
``[MASK]`` or, with ``random_ratio``, one random token. Sample ``i``
draws from ``RandomState(seed + i)``, so it is the JAX package's
bitwise.

Word units come from ``zh_tokenizer``: ``None`` means ``jieba.lcut``
and raises ``ImportError`` where ``jieba`` is not installed, ``False``
groups wordpieces by their ``##`` prefix, and a callable segments the
text itself. The JAX package falls back to the wordpiece grouping when
``jieba`` does not import (:54-61); the port asks for ``False``
instead (ROADMAP.md, differences from the reference).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.data.data_utils.mask_utils import (jieba_lcut,
                                                           whole_word_spans)
from fengshen_tpu_torch.data.megatron_dataloader.indexed_dataset import (
    MMapIndexedDataset)


def _poisson_span_lengths(n: int, lam: float, np_rng) -> np.ndarray:
    """``n`` span lengths of at least 1 from Poisson(``lam``)."""
    return np.maximum(np_rng.poisson(lam, size=n), 1)


class BartDataset:
    """Denoising samples ``{input_ids, attention_mask, labels}`` (:33),
    ``int32 [max_seq_length]`` each, labels -100 past the target."""

    def __init__(self, indexed: MMapIndexedDataset, tokenizer: Any,
                 max_seq_length: int = 512, masked_lm_prob: float = 0.15,
                 permute_sentence_ratio: float = 1.0,
                 random_ratio: float = 0.1, poisson_lambda: float = 3.0,
                 seed: int = 0, zh_tokenizer: Optional[Any] = None):
        self.indexed = indexed
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.mask_ratio = masked_lm_prob
        self.permute_sentence_ratio = permute_sentence_ratio
        self.random_ratio = random_ratio
        self.poisson_lambda = poisson_lambda
        self.seed = seed
        if zh_tokenizer is None:
            zh_tokenizer = jieba_lcut("BartDataset")
        self.zh_tokenizer = zh_tokenizer or None
        vocab = tokenizer.get_vocab()
        self.vocab_id_to_token = {v: k for k, v in vocab.items()}
        self.vocab_size = len(vocab)
        self.doc_idx = np.asarray(indexed.doc_idx, np.int64)

    def __len__(self) -> int:
        return len(self.doc_idx) - 1

    def _permute_sentences(self, tokens: list, np_rng) -> list:
        """Shuffle the ``[SEP]``-ended sentences, ``[CLS]`` kept first
        (:74)."""
        sep = self.tokenizer.sep_token_id
        sents, cur = [], []
        for t in tokens[1:]:
            cur.append(t)
            if t == sep:
                sents.append(cur)
                cur = []
        if cur:
            sents.append(cur)
        if len(sents) <= 1:
            return tokens
        n = len(sents)
        num_to_permute = math.ceil(n * self.permute_sentence_ratio)
        order = np.arange(n)
        chosen = np_rng.permutation(n)[:num_to_permute]
        order[np.sort(chosen)] = chosen
        out = [tokens[0]]
        for i in order:
            out.extend(sents[i])
        return out

    def _whole_word_mask(self, tokens: list, np_rng) -> list:
        """Poisson-span whole-word infilling (:98): each chosen run of
        words collapses to one mask token (or a random one)."""
        tok = self.tokenizer
        specials = {tok.cls_token_id, tok.sep_token_id}
        token_strs = [self.vocab_id_to_token.get(t, str(t)) for t in tokens]
        units = whole_word_spans(token_strs, self.vocab_id_to_token,
                                 self.zh_tokenizer)
        cand = [u for u in units
                if all(tokens[i] not in specials for i in u)]
        if not cand:
            return tokens
        # twice the ratio: the decoder reconstructs the whole text
        n_to_mask = max(1, int(round(
            sum(len(u) for u in cand) * self.mask_ratio * 2)))
        order = np_rng.permutation(len(cand))
        span_lens = _poisson_span_lengths(len(cand), self.poisson_lambda,
                                          np_rng)
        drop: set = set()
        mask_at: dict = {}
        covered = 0
        for oi, ui in enumerate(order):
            if covered >= n_to_mask:
                break
            start = int(ui)
            span = cand[start: start + int(span_lens[oi])]
            idxs = [i for u in span for i in u]
            if not idxs or any(i in drop or i in mask_at for i in idxs):
                continue
            keep = min(idxs)
            if np_rng.random() < self.random_ratio:
                mask_at[keep] = int(np_rng.randint(5, self.vocab_size))
            else:
                mask_at[keep] = tok.mask_token_id
            drop.update(i for i in idxs if i != keep)
            covered += len(idxs)
        out = []
        for i, t in enumerate(tokens):
            if i in mask_at:
                out.append(mask_at[i])
            elif i not in drop:
                out.append(t)
        return out

    def __getitem__(self, idx: int) -> dict:
        tok = self.tokenizer
        np_rng = np.random.RandomState((self.seed + idx) % (2 ** 31))
        lo, hi = int(self.doc_idx[idx]), int(self.doc_idx[idx + 1])
        tokens = [tok.cls_token_id]
        for i in range(lo, hi):
            tokens.extend(np.asarray(self.indexed[i]).tolist())
            if tokens[-1] != tok.sep_token_id:
                tokens.append(tok.sep_token_id)
        tokens = tokens[: self.max_seq_length]
        tokens[-1] = tok.sep_token_id

        target = tokens[1:]
        source = tokens
        if self.permute_sentence_ratio > 0.0:
            source = self._permute_sentences(source, np_rng)
        if self.mask_ratio > 0.0:
            source = self._whole_word_mask(source, np_rng)

        pad_id = tok.pad_token_id or 0
        src = np.full((self.max_seq_length,), pad_id, np.int32)
        src[: len(source)] = source[: self.max_seq_length]
        labels = np.full((self.max_seq_length,), -100, np.int32)
        labels[: len(target)] = target[: self.max_seq_length]
        return {"input_ids": src,
                "attention_mask": (src != pad_id).astype(np.int32),
                "labels": labels}
