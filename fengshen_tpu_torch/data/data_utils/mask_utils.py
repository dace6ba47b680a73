"""Whole-word grouping of wordpieces: the part of
``fengshen_tpu/data/data_utils/mask_utils.py`` (:24-66) that
``data/megatron_dataloader/bart_dataset.py`` uses.
``create_masked_lm_predictions`` is not yet ported (its users are the
BERT pretraining examples)."""

from __future__ import annotations

from typing import Callable, Optional


def is_start_piece(piece: str) -> bool:
    """A wordpiece that starts a word (no ``##`` prefix)."""
    return not piece.startswith("##")


def whole_word_spans(tokens: list, vocab_id_to_token: Optional[dict] = None,
                     zh_tokenizer: Optional[Callable] = None) -> list:
    """Token indices grouped into maskable word units (:29). With
    ``zh_tokenizer`` (``jieba.lcut`` for Chinese) the pieces are joined
    back into text, segmented into words, and each word takes the
    pieces that spell it; a tail the words do not cover goes one piece
    a unit. Without it, a ``##`` piece joins the word before it."""
    del vocab_id_to_token
    if zh_tokenizer is not None:
        text = "".join(t[2:] if t.startswith("##") else t for t in tokens)
        words = list(zh_tokenizer(text))
        spans: list = []
        ti = 0
        for w in words:
            span: list = []
            consumed = 0
            while ti < len(tokens) and consumed < len(w):
                piece = tokens[ti]
                plain = piece[2:] if piece.startswith("##") else piece
                span.append(ti)
                consumed += len(plain)
                ti += 1
            if span:
                spans.append(span)
        while ti < len(tokens):
            spans.append([ti])
            ti += 1
        return spans

    spans = []
    for i, tok in enumerate(tokens):
        if is_start_piece(tok) or not spans:
            spans.append([i])
        else:
            spans[-1].append(i)
    return spans
