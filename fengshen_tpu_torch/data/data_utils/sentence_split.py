"""Chinese sentence splitting: the port of
``fengshen_tpu/data/data_utils/sentence_split.py``
(``ChineseSentenceSplitter``, :14)."""

from __future__ import annotations

import re

# sentence-final punctuation, with a closing quote attached
_SPLIT_PATTERN = re.compile(
    r'([。！？\?!…]+[”’"\']?)')


class ChineseSentenceSplitter:
    """Split text into sentences on Chinese terminal punctuation, keeping
    the punctuation attached to its sentence."""

    def tokenize(self, text: str) -> list[str]:
        pieces = _SPLIT_PATTERN.split(text)
        sentences: list[str] = []
        for i in range(0, len(pieces) - 1, 2):
            sent = (pieces[i] + pieces[i + 1]).strip()
            if sent:
                sentences.append(sent)
        tail = pieces[-1].strip() if len(pieces) % 2 == 1 else ""
        if tail:
            sentences.append(tail)
        return sentences

    __call__ = tokenize
