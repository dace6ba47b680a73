"""``[CLS]``/``[SEP]`` assembly with token types: the port of
``fengshen_tpu/data/data_utils/token_type_utils.py``
(``create_tokens_and_tokentypes``, :8)."""

from __future__ import annotations


def create_tokens_and_tokentypes(tokens_a: list[int], tokens_b: list[int],
                                 cls_id: int, sep_id: int
                                 ) -> tuple[list[int], list[int]]:
    """``[CLS] A [SEP]`` (then ``B [SEP]`` when B is not empty), with
    segment ids 0 for the first part and 1 for the second."""
    tokens = [cls_id] + list(tokens_a) + [sep_id]
    tokentypes = [0] * len(tokens)
    if tokens_b:
        tokens += list(tokens_b) + [sep_id]
        tokentypes += [1] * (len(tokens_b) + 1)
    return tokens, tokentypes
