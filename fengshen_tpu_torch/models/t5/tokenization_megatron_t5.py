"""Randeng-T5-Char tokenizer: the port of
``fengshen_tpu/models/t5/tokenization_megatron_t5.py``, a
``BertTokenizer`` carrying the T5 special surface.

The char-level Randeng checkpoints ship a BERT ``vocab.txt`` rather than
a sentencepiece model; :meth:`T5Tokenizer.from_pretrained` returns a
``BertTokenizer`` with ``[BOS]``, ``[EOS]`` and 118 ``<extra_id_i>``
span-corruption sentinels as additional special tokens (:20-32), binds
``bos_token`` / ``eos_token`` when the markers resolve, and exposes
``sentinel_token_ids``. ``transformers`` is imported inside that method
only, so importing this module loads no ``transformers``.
"""

from __future__ import annotations

DEFAULT_EXTRA_ID_NUM = 118


class T5Tokenizer:
    """Factory matching the reference class shape: use
    ``T5Tokenizer.from_pretrained(vocab_path)``."""

    def __init__(self, extra_id_num: int = DEFAULT_EXTRA_ID_NUM):
        self.extra_id_num = extra_id_num

    @classmethod
    def from_pretrained(cls, vocab_path: str,
                        extra_id_num: int = DEFAULT_EXTRA_ID_NUM):
        from transformers import BertTokenizer
        special_tokens = ["[BOS]", "[EOS]"] + \
            [f"<extra_id_{i}>" for i in range(extra_id_num)]
        tokenizer = BertTokenizer.from_pretrained(
            vocab_path, additional_special_tokens=special_tokens)
        # bind the T5 special surface when the markers resolve (added
        # specials always resolve; [BOS]/[EOS] may also live in vocab.txt)
        unk = tokenizer.unk_token_id
        if tokenizer.convert_tokens_to_ids("[EOS]") != unk:
            tokenizer.eos_token = "[EOS]"
        if tokenizer.convert_tokens_to_ids("[BOS]") != unk:
            tokenizer.bos_token = "[BOS]"
        tokenizer.extra_id_num = extra_id_num
        tokenizer.sentinel_token_ids = [
            tokenizer.convert_tokens_to_ids(f"<extra_id_{i}>")
            for i in range(extra_id_num)]
        return tokenizer
