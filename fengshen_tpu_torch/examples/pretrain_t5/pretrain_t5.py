"""Randeng-T5 / mT5 span-corruption pretraining: the port of
``fengshen_tpu/examples/pretrain_t5/pretrain_t5.py``, the script behind
``pretrain_randeng_t5_char_{57M,700M,10B}.sh``,
``pretrain_randeng_t5_large.sh`` and the ``pretrain_mt5_small*.sh``
shells.

Ported: :func:`trim_vocab` (:29: the embedding and untied head rows of
``--keep_tokens_path`` kept, in its order), :class:`T5PretrainModule`
(:44: teacher-forced CE over the span-corruption targets, and ``acc``,
the share of target tokens whose logit argmax is the label) and
:func:`main` (:122: ``--tokenizer_type``, ``--new_vocab_path``,
``--noise_density``, ``--mean_noise_span_length`` and
``--do_eval_only``, which restores the checkpoint and runs one
validation sweep, no step).

Port differences: the tokenizer is the caller's (``tokenizer=``), else
the char-level ``T5Tokenizer`` of ``--new_vocab_path`` or
``--model_path`` (``--tokenizer_type bert_tokenizer``), else
``models/auto.AutoTokenizer`` of the same directory; ``--keep_tokens_path``
reads ``--model_path``'s checkpoint through
``utils/convert_common.load_torch_checkpoint`` and builds the model at
the kept vocabulary's size (the JAX package keeps the config's);
without it, ``--model_path`` holding weights loads them, as in
``examples/summary``, where the JAX package draws random ones. Dropout
comes from the Trainer's per-step generator (``ops/dropout.py``).

Run (on the card; ``--device cpu`` for the CPU), as the 700M shell:
    python -m fengshen_tpu_torch.examples.pretrain_t5.pretrain_t5 \\
        --tokenizer_type bert_tokenizer --model_path <randeng-t5-dir> \\
        --train_file train.json --default_root_dir runs \\
        --save_ckpt_path ckpt --load_ckpt_path ckpt --train_batchsize 8 \\
        --max_seq_length 512 --learning_rate 1e-4 \\
        --min_learning_rate 1e-5 --warmup_steps 10000 --max_steps 100000 \\
        --every_n_train_steps 5000 --precision bf16 --seed 1234
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from fengshen_tpu_torch.data.t5_dataloader import (
    T5SpanCorruptionCollator, compute_input_and_target_lengths)
from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqModule, common_parser)
from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)


def trim_vocab(state_dict: dict, keep_tokens) -> dict:
    """The port's T5 state dict with the rows of ``shared`` (and of an
    untied ``lm_head``) at ``keep_tokens`` kept, in that order (:29)."""
    idx = torch.as_tensor(np.asarray(keep_tokens, np.int64))
    out = dict(state_dict)
    for name in ("model.shared.weight", "shared.weight", "lm_head.weight"):
        if name in out:
            out[name] = out[name][idx.to(out[name].device)]
    return out


def read_keep_tokens(path: str) -> list:
    with open(path) as f:
        return json.load(f)


class T5PretrainModule(Seq2SeqModule):
    """Span-corruption loss (:44) over a port T5 holding its weights."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("T5 pretrain")
        parser.add_argument("--keep_tokens_path", default=None, type=str)
        parser.add_argument(
            "--new_vocab_path", default=None, type=str,
            help="tokenizer matching the --keep_tokens_path order")
        parser.add_argument("--max_seq_length", type=int, default=512)
        parser.add_argument(
            "--do_eval_only", action="store_true",
            help="restore the checkpoint and run one validation sweep "
                 "only")
        parser.add_argument("--noise_density", type=float, default=0.15)
        parser.add_argument("--mean_noise_span_length", type=float,
                            default=3.0)
        parser.add_argument(
            "--tokenizer_type", default="t5_tokenizer", type=str,
            choices=["t5_tokenizer", "bert_tokenizer"],
            help="bert_tokenizer = the char-level Randeng vocabulary "
                 "behind models/t5's T5Tokenizer")
        return parent_parser

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        """With ``--keep_tokens_path``: the checkpoint of
        ``--model_path`` (which must hold one), its vocabulary trimmed
        (:74); else as :class:`Seq2SeqModule`."""
        keep_path = getattr(self.args, "keep_tokens_path", None)
        if not keep_path:
            return super().init_params(generator)
        from fengshen_tpu_torch.models.t5.convert import torch_to_params
        from fengshen_tpu_torch.utils.convert_common import (
            load_torch_checkpoint)
        state = torch_to_params(load_torch_checkpoint(self.args.model_path),
                                self.config)
        with torch.no_grad():
            self.model.load_state_dict(
                trim_vocab(state, read_keep_tokens(keep_path)))
        return self.model

    def training_loss(self, batch: dict) -> tuple:
        logits = self._logits(batch)
        labels = batch["labels"]
        loss, n_tokens = vocab_parallel_cross_entropy(logits, labels)
        valid = labels != -100
        acc = ((logits.argmax(-1) == labels) & valid).sum() / \
            valid.sum().clamp(min=1)
        return loss, {"acc": acc, "n_tokens": n_tokens}

    def sequence_lengths(self) -> tuple:
        """``--max_seq_length`` encoder tokens and the collator's
        target length (114 at 512)."""
        args = self.args
        _, targets = compute_input_and_target_lengths(
            args.max_seq_length, args.noise_density,
            args.mean_noise_span_length)
        return int(args.max_seq_length), int(targets)


def load_tokenizer(args):
    """The tokenizer ``--tokenizer_type`` names, from ``--new_vocab_path``
    or ``--model_path``."""
    path = getattr(args, "new_vocab_path", None) or args.model_path
    if args.tokenizer_type == "bert_tokenizer":
        from fengshen_tpu_torch.models.t5 import T5Tokenizer
        return T5Tokenizer.from_pretrained(path)
    from fengshen_tpu_torch.models.auto import AutoTokenizer
    return AutoTokenizer.from_pretrained(path)


def parse_args(argv=None):
    parser = common_parser("Pretrain Unsupervise.")
    return T5PretrainModule.add_module_specific_args(parser).parse_args(argv)


def main(argv=None, tokenizer=None):
    """Fit (or, with ``--do_eval_only``, validate the restored
    checkpoint) and return the Trainer."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.t5 import (T5Config,
                                              T5ForConditionalGeneration)
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args)
    config = T5Config.from_pretrained(args.model_path)
    if args.keep_tokens_path:
        config = dataclasses.replace(
            config, vocab_size=len(read_keep_tokens(args.keep_tokens_path)))
    model = T5ForConditionalGeneration(config, device=trainer.device,
                                       init=False)
    collator = T5SpanCorruptionCollator(
        tokenizer, max_seq_length=args.max_seq_length,
        noise_density=args.noise_density,
        mean_noise_span_length=args.mean_noise_span_length)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    module = T5PretrainModule(args, model, config)
    trainer.callbacks.append(UniversalCheckpoint(args))
    if args.do_eval_only:
        trainer.validate(module, datamodule)
    else:
        trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
