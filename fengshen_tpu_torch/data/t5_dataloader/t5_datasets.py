"""T5 span-corruption data: the port of
``fengshen_tpu/data/t5_dataloader/t5_datasets.py``, bitwise its arrays
for the same seed.

:func:`compute_input_and_target_lengths` (mesh-tf's) gives the raw
token count whose corruption fills ``inputs_length`` encoder positions
(512 -> 568 raw tokens, 114 target tokens at density 0.15 and spans of
3); :func:`random_spans_noise_mask` draws the noise spans;
:class:`T5SpanCorruptionCollator` turns text into encoder inputs with
one sentinel per noise span and targets of each sentinel followed by
the span it hides, then eos.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


def compute_input_and_target_lengths(inputs_length: int,
                                     noise_density: float,
                                     mean_noise_span_length: float) -> tuple:
    """``(raw tokens, target tokens)`` whose corruption yields exactly
    ``inputs_length`` encoder tokens (:20)."""

    def lengths(tokens_length: int) -> tuple:
        num_noise_tokens = int(round(tokens_length * noise_density))
        num_nonnoise_tokens = tokens_length - num_noise_tokens
        num_spans = max(int(round(num_noise_tokens /
                                  mean_noise_span_length)), 1)
        # inputs: non-noise tokens + one sentinel per span + eos
        return (num_nonnoise_tokens + num_spans + 1,
                num_noise_tokens + num_spans + 1)

    tokens_length = inputs_length
    while lengths(tokens_length + 1)[0] <= inputs_length:
        tokens_length += 1
    return tokens_length, lengths(tokens_length)[1]


def random_spans_noise_mask(length: int, noise_density: float,
                            mean_noise_span_length: float,
                            np_rng) -> np.ndarray:
    """Boolean ``[length]`` mask of noise positions in random spans,
    starting with a non-noise span (:46)."""
    num_noise = int(round(length * noise_density))
    num_noise = min(max(num_noise, 1), length - 1)
    num_spans = max(int(round(num_noise / mean_noise_span_length)), 1)
    num_nonnoise = length - num_noise

    def random_segmentation(total, n):
        ids = np.arange(total - 1) < n - 1
        np_rng.shuffle(ids)
        starts = np.concatenate([[True], ids])
        segment = np.cumsum(starts) - 1
        return np.bincount(segment, minlength=n)

    noise_spans = random_segmentation(num_noise, num_spans)
    nonnoise_spans = random_segmentation(num_nonnoise, num_spans)
    interleaved = np.zeros((num_spans * 2,), np.int64)
    interleaved[0::2] = nonnoise_spans
    interleaved[1::2] = noise_spans
    span_starts = np.cumsum(interleaved)[:-1]
    indicator = np.zeros((length,), bool)
    indicator[span_starts] = True
    segment = np.cumsum(indicator)
    return (segment % 2) == 1


@dataclass
class T5SpanCorruptionCollator:
    """Text -> ``input_ids``, ``attention_mask`` ``[B, max_seq_length]``
    and ``decoder_input_ids``, ``labels`` ``[B, targets_length]`` (:82).
    The noise is drawn from ``np_rng``, seeded once from ``seed``, so
    successive batches differ and a run repeats. Sentinels are the
    tokenizer's ``sentinel_token_ids`` (the char-level T5 tokenizer's
    ascending ``<extra_id_i>``), else the last 100 ids descending
    (sentencepiece T5's); a span past the last sentinel reuses it."""

    tokenizer: Any
    max_seq_length: int = 512
    noise_density: float = 0.15
    mean_noise_span_length: float = 3.0
    content_key: str = "text"
    seed: int = 42
    decoder_start_token_id: int = 0

    def __post_init__(self):
        self.np_rng = np.random.RandomState(self.seed)
        self.tokens_length, self.targets_length = \
            compute_input_and_target_lengths(
                self.max_seq_length, self.noise_density,
                self.mean_noise_span_length)
        sentinels = getattr(self.tokenizer, "sentinel_token_ids", None)
        if sentinels:
            self.sentinels = list(sentinels)
        else:
            self.sentinels = [len(self.tokenizer) - 1 - i
                              for i in range(100)]
        self.eos = self.tokenizer.eos_token_id or 1
        self.pad = self.tokenizer.pad_token_id or 0

    def _corrupt(self, ids: list) -> tuple:
        ids = ids[: self.tokens_length]
        if len(ids) < 2:
            ids = ids + [self.eos]
        mask = random_spans_noise_mask(len(ids), self.noise_density,
                                       self.mean_noise_span_length,
                                       self.np_rng)
        inp, tgt = [], []
        span_i = 0
        prev_noise = False
        for tok, is_noise in zip(ids, mask):
            if is_noise:
                if not prev_noise:
                    sentinel = self.sentinels[
                        min(span_i, len(self.sentinels) - 1)]
                    inp.append(sentinel)
                    tgt.append(sentinel)
                    span_i += 1
                tgt.append(tok)
            else:
                inp.append(tok)
            prev_noise = bool(is_noise)
        inp.append(self.eos)
        tgt.append(self.eos)
        return inp, tgt

    def __call__(self, samples: list) -> dict:
        batch = {"input_ids": [], "attention_mask": [],
                 "decoder_input_ids": [], "labels": []}
        for s in samples:
            text = s[self.content_key] if isinstance(s, dict) else s
            ids = self.tokenizer.encode(text, add_special_tokens=False)
            inp, tgt = self._corrupt(ids)
            inp = inp[: self.max_seq_length]
            tgt = tgt[: self.targets_length]
            dec_in = [self.decoder_start_token_id] + tgt[:-1]
            pad_i = self.max_seq_length - len(inp)
            pad_t = self.targets_length - len(tgt)
            batch["input_ids"].append(inp + [self.pad] * pad_i)
            batch["attention_mask"].append([1] * len(inp) + [0] * pad_i)
            batch["decoder_input_ids"].append(dec_in + [self.pad] * pad_t)
            batch["labels"].append(tgt + [-100] * pad_t)
        return {k: np.asarray(v) for k, v in batch.items()}
