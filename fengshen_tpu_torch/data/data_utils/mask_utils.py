"""Masked-LM sample construction: the port of
``fengshen_tpu/data/data_utils/mask_utils.py``.

:func:`whole_word_spans` groups wordpieces into word units (the BART
denoising dataset uses it too); :func:`create_masked_lm_predictions`
(:65-128) picks units in a ``np_rng`` permutation until the prediction
budget is met and masks them, BERT style (80 % ``[MASK]``, 10 % a
random vocabulary id, 10 % kept) or T5 style (always ``[MASK]``). Its
draws from ``np_rng`` come in the JAX package's order: one permutation
over the units, then per masked token one ``random()`` and, on the
random-id branch, one ``randint``; so the same ``RandomState`` gives
the same sample bitwise.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

MaskedLmInstance = collections.namedtuple("MaskedLmInstance",
                                          ["index", "label"])


def jieba_lcut(owner: str, option: str = "zh_tokenizer",
               fallback: str = "group wordpieces by their '##' prefix"
               ) -> Callable:
    """``jieba.lcut``, the default word segmenter of Chinese whole-word
    masking; without ``jieba`` this raises ``ImportError`` naming
    ``owner``'s ``option=False`` (which does ``fallback``), where the
    JAX package falls back quietly."""
    try:
        import jieba
    except ImportError as e:
        raise ImportError(
            f"{owner}({option}=None) segments words with jieba, which is "
            f"not installed; pass {option}=False to {fallback}, or a "
            "segmenting callable") from e
    return jieba.lcut


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


def create_masked_lm_predictions(
        tokens: list, vocab_id_list: list, vocab_id_to_token_dict: dict,
        masked_lm_prob: float, cls_id: int, sep_id: int, mask_id: int,
        max_predictions_per_seq: int, np_rng, masking_style: str = "bert",
        zh_tokenizer: Optional[Callable] = None,
        do_whole_word_mask: bool = True) -> tuple:
    """``(output_tokens, masked_positions, masked_labels)`` of one
    sample. Candidates are the word units of :func:`whole_word_spans`
    (single tokens without ``do_whole_word_mask``) that hold no
    ``[CLS]``/``[SEP]``; ``round(len(tokens) * masked_lm_prob)`` tokens
    (at least 1, at most ``max_predictions_per_seq``) are predicted, a
    unit that would overshoot the budget skipped. Positions come out
    sorted."""
    special = {cls_id, sep_id}
    token_strs = [vocab_id_to_token_dict.get(t, str(t)) for t in tokens]
    if do_whole_word_mask:
        units = whole_word_spans(token_strs, vocab_id_to_token_dict,
                                 zh_tokenizer)
        cand_units = [u for u in units
                      if all(tokens[i] not in special for i in u)]
    else:
        cand_units = [[i] for i, t in enumerate(tokens) if t not in special]

    num_to_predict = min(max_predictions_per_seq,
                         max(1, int(round(len(tokens) * masked_lm_prob))))
    order = np_rng.permutation(len(cand_units))
    output = list(tokens)
    masked: list = []
    covered: set = set()
    for ui in order:
        unit = cand_units[int(ui)]
        if len(masked) + len(unit) > num_to_predict:
            continue
        if any(i in covered for i in unit):
            continue
        covered.update(unit)
        for i in unit:
            masked.append(MaskedLmInstance(index=i, label=tokens[i]))
            if masking_style == "bert":
                r = np_rng.random()
                if r < 0.8:
                    output[i] = mask_id
                elif r < 0.9:
                    output[i] = int(vocab_id_list[
                        np_rng.randint(0, len(vocab_id_list))])
            elif masking_style == "t5":
                output[i] = mask_id
            else:
                raise ValueError(f"unknown masking style {masking_style!r}")
        if len(masked) >= num_to_predict:
            break

    masked.sort(key=lambda x: x.index)
    return (output, [m.index for m in masked], [m.label for m in masked])
