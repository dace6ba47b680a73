"""Randeng-Pegasus gap-sentence-generation (GSG) pretraining: the port
of ``fengshen_tpu/examples/pegasus/pretrain_pegasus.py`` (driven by
``pretrain_pegasus.sh``).

A document is split into sentences at Chinese terminal punctuation
(:func:`split_sentences`); each sentence is scored by character-unigram
F1 against the rest (:func:`unigram_f1`); the top ``--gsg_ratio`` of
them (:func:`gap_sentence_ids`) become the target, each replaced by
``[MASK]`` in the source (:class:`PegasusGSGCollator`), and
:class:`PegasusPretrainModule` trains seq2seq CE over them.

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.pegasus.pretrain_pegasus \\
        --model_path <randeng-pegasus> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 32 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 \\
        --max_seq_length 512 --gsg_ratio 0.25
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass

import numpy as np

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqCollator, Seq2SeqModule, common_parser)

_SENT_SPLIT = re.compile(r"([。！？!?；;\n]+)")


def split_sentences(text: str) -> list:
    """Sentences ending at Chinese terminal punctuation (:35)."""
    parts = _SENT_SPLIT.split(text)
    sents = []
    for i in range(0, len(parts) - 1, 2):
        s = (parts[i] + parts[i + 1]).strip()
        if s:
            sents.append(s)
    if len(parts) % 2 == 1 and parts[-1].strip():
        sents.append(parts[-1].strip())
    return sents


def unigram_f1(source: str, target: str) -> float:
    """Character-unigram overlap F1 (:49)."""
    a, b = Counter(source), Counter(target)
    overlap = sum((a & b).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(a.values()), 1)
    r = overlap / max(sum(b.values()), 1)
    return 2 * p * r / (p + r)


def gap_sentence_ids(sents: list, ratio: float) -> list:
    """The ``max(1, int(len(sents) x ratio))`` sentences scoring highest
    against the rest of the document, in document order (:61)."""
    n_select = max(1, int(len(sents) * ratio))
    scores = []
    for i, s in enumerate(sents):
        rest = "".join(sents[:i] + sents[i + 1:])
        scores.append(unigram_f1(s, rest))
    return sorted(np.argsort(scores)[::-1][:n_select].tolist())


@dataclass
class PegasusGSGCollator(Seq2SeqCollator):
    """document -> (source with the gap sentences masked, the gap
    sentences) (:73); batching is :class:`Seq2SeqCollator`'s."""

    gsg_ratio: float = 0.25
    content_key: str = "text"
    mask_sentence_token: str = "[MASK]"

    def _split(self, sample: dict) -> tuple:
        # source_text and target_text run back to back on one sample:
        # the scoring, quadratic in sentences, runs once
        if getattr(self, "_memo_sample", None) is sample:
            return self._memo_val
        sents = split_sentences(sample[self.content_key])
        if not sents:
            sents = [sample[self.content_key] or self.mask_sentence_token]
        result = (sents, set(gap_sentence_ids(sents, self.gsg_ratio)))
        self._memo_sample, self._memo_val = sample, result
        return result

    def source_text(self, sample: dict) -> str:
        sents, selected = self._split(sample)
        return "".join(self.mask_sentence_token if i in selected else s
                       for i, s in enumerate(sents))

    def target_text(self, sample: dict) -> str:
        sents, selected = self._split(sample)
        return "".join(s for i, s in enumerate(sents) if i in selected)


class PegasusPretrainModule(Seq2SeqModule):
    """GSG seq2seq CE (:112)."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Pegasus pretrain")
        parser.add_argument("--max_seq_length", type=int, default=512)
        parser.add_argument("--max_target_length", type=int, default=128)
        parser.add_argument("--gsg_ratio", type=float, default=0.25)
        return parent_parser

    def sequence_lengths(self) -> tuple:
        return int(self.args.max_seq_length), \
            int(self.args.max_target_length)


def main(argv=None, tokenizer=None):
    """Fit; return the Trainer. ``tokenizer`` defaults to
    ``--model_path``'s."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import \
        build_model
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = PegasusPretrainModule.add_module_specific_args(
        common_parser()).parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    collator = PegasusGSGCollator(
        tokenizer, max_src_length=args.max_seq_length,
        max_tgt_length=args.max_target_length,
        decoder_start_token_id=tokenizer.pad_token_id or 0,
        gsg_ratio=args.gsg_ratio)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    model, config = build_model("pegasus", args.model_path,
                                device=trainer.device)
    module = PegasusPretrainModule(args, model, config)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
