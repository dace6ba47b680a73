"""ROUGE-1/2/L for summarization eval: the port's own copy of
``fengshen_tpu/metrics/rouge.py`` (pure Python).

The reference scores summaries with torchmetrics' ROUGEScore after
splitting Chinese into space-separated chars
(reference: fengshen/examples/summary/seq2seq_summary.py:12,87-96).
The port does not depend on torchmetrics: the three standard variants
are implemented directly: n-gram overlap F-measure (rouge1/rouge2) and
LCS-based F-measure (rougeL), over whitespace-split tokens.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


def _fmeasure(match: int, pred_total: int, ref_total: int) -> float:
    if pred_total == 0 or ref_total == 0 or match == 0:
        return 0.0
    p = match / pred_total
    r = match / ref_total
    return 2 * p * r / (p + r)


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y
                       else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_n(pred: str, ref: str, n: int) -> float:
    p, r = pred.split(), ref.split()
    if len(p) < n or len(r) < n:
        return 0.0
    pg, rg = _ngrams(p, n), _ngrams(r, n)
    match = sum((pg & rg).values())
    return _fmeasure(match, sum(pg.values()), sum(rg.values()))


def rouge_l(pred: str, ref: str) -> float:
    p, r = pred.split(), ref.split()
    return _fmeasure(_lcs_len(p, r), len(p), len(r))


def chinese_char_split(text: str) -> str:
    """Space-separate chars so char-level ROUGE works for Chinese — the
    reference's normalisation before `rouge_metric.update`
    (reference: seq2seq_summary.py:87-91)."""
    return " ".join(list(text.replace(" ", "")))


def rouge_scores(preds: Iterable[str], refs: Iterable[str],
                 keys: tuple = ("rouge1", "rouge2", "rougeL"),
                 char_level: bool = True) -> dict:
    """Corpus-mean F-measures for the requested keys."""
    fns = {"rouge1": lambda p, r: rouge_n(p, r, 1),
           "rouge2": lambda p, r: rouge_n(p, r, 2),
           "rougeL": rouge_l}
    sums = {k: 0.0 for k in keys}
    count = 0
    for pred, ref in zip(preds, refs):
        if char_level:
            pred, ref = chinese_char_split(pred), chinese_char_split(ref)
        for k in keys:
            sums[k] += fns[k](pred, ref)
        count += 1
    return {f"{k}_fmeasure": (sums[k] / count if count else 0.0)
            for k in keys}
