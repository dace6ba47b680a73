"""BERT whole-word-masking pretraining: the port of
``fengshen_tpu/examples/pretrain_bert/pretrain_bert.py`` (driven by
``pretrain_bert.sh``).

:class:`WWMBertCollator` (:28-99) cuts each text into words, masks
n-gram spans of words (a word starts a span with probability
``--masked_lm_prob`` unless it has four or more characters; the span's
length n is drawn with p(n) proportional to 1/n up to ``--max_ngram``),
replaces each masked token 80 % by ``[MASK]``, 10 % by itself and 10 %
by a random id below ``len(tokenizer)``, and pads to
``--max_seq_length`` with labels -100 off the masked tokens. Every draw
comes from one ``RandomState(seed)`` in the JAX package's order, so the
batches are its batches bitwise. :class:`BertPretrainModule` (:102-139)
takes the MLM CE on ``BertForMaskedLM`` and logs ``mlm_acc`` and
``n_tokens``.

:class:`MaskedLMModule` is the module the three MLM pretraining
examples share (this one, ``pretrain_erlangshen_bert`` and
``pretrain_erlangshen_deberta_v2``): the model holds its weights, drawn
from the step-0 generator, then replaced by ``--model_path``'s HF
checkpoint where the directory holds one (the JAX modules always draw
random weights), and the loss reads the step's dropout generator.

``main(tokenizer=..., word_cuter=...)``: the tokenizer defaults to
``--model_path``'s (``models/auto.AutoTokenizer``); the word cutter to
``jieba.lcut``, which raises ``ImportError`` where ``jieba`` is not
installed. ``word_cuter=False`` cuts per character (what the JAX
collator falls back to quietly without ``jieba``), a callable cuts
itself.

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.pretrain_bert.pretrain_bert \\
        --model_path <bert-base-chinese> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 32 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 \\
        --max_seq_length 512 --masked_lm_prob 0.15
"""

from __future__ import annotations

import argparse
import importlib
import logging
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from fengshen_tpu_torch.data.data_utils.rng_state import SeededCollator
from fengshen_tpu_torch.models.layers import init_weights
from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)
from fengshen_tpu_torch.trainer.module import TrainModule

logger = logging.getLogger("fengshen_tpu_torch.pretrain")


def _characters(text: str) -> list:
    return list(text)


@dataclass
class WWMBertCollator(SeededCollator):
    """Text -> whole-word n-gram MLM batch (:28): ``input_ids``,
    ``attention_mask``, ``token_type_ids`` (all 0) and ``labels``,
    ``[B, max_seq_length]``. ``word_cuter``: None is ``jieba.lcut``
    (raising without ``jieba``), False cuts per character."""

    tokenizer: Any
    max_seq_length: int = 512
    mask_rate: float = 0.15
    max_ngram: int = 3
    content_key: str = "text"
    seed: int = 42
    word_cuter: Optional[Any] = None

    def __post_init__(self):
        from fengshen_tpu_torch.data.data_utils.mask_utils import jieba_lcut
        if self.word_cuter is None:
            self.word_cuter = jieba_lcut("WWMBertCollator", "word_cuter",
                                         "cut per character")
        elif self.word_cuter is False:
            self.word_cuter = _characters
        self.np_rng = np.random.RandomState(self.seed)
        self.ngrams = np.arange(1, self.max_ngram + 1)
        pvals = 1.0 / np.arange(1, self.max_ngram + 1)
        self.pvals = pvals / pvals.sum()
        self.vocab_length = len(self.tokenizer)

    def _token_process(self, token_id: int) -> int:
        """80 % ``[MASK]``, 10 % kept, 10 % a random id in ``[1,
        len(tokenizer))`` (:52)."""
        r = self.np_rng.random()
        if r <= 0.8:
            return self.tokenizer.mask_token_id
        if r <= 0.9:
            return token_id
        return int(self.np_rng.randint(1, self.vocab_length))

    def __call__(self, samples: list) -> dict:
        tok = self.tokenizer
        max_len = self.max_seq_length
        batch = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
                 "labels": []}
        for sample in samples:
            words = self.word_cuter(sample[self.content_key])
            mask_ids: list = []
            labels: list = []
            i = 0
            while i < len(words):
                rand = self.np_rng.random()
                if rand > self.mask_rate or len(words[i]) >= 4:
                    for t in tok.encode(words[i], add_special_tokens=False):
                        mask_ids.append(t)
                        labels.append(-100)
                    i += 1
                    continue
                n = int(self.np_rng.choice(self.ngrams, p=self.pvals))
                for word in words[i: i + n]:
                    for t in tok.encode(word, add_special_tokens=False):
                        mask_ids.append(self._token_process(t))
                        labels.append(t)
                i += n
            pad_id = tok.pad_token_id or 0
            ids = [tok.cls_token_id] + mask_ids[: max_len - 2] + \
                [tok.sep_token_id]
            lab = [-100] + labels[: max_len - 2] + [-100]
            pad = max_len - len(ids)
            batch["input_ids"].append(ids + [pad_id] * pad)
            batch["attention_mask"].append([1] * len(ids) + [0] * pad)
            batch["token_type_ids"].append([0] * max_len)
            batch["labels"].append(lab + [-100] * pad)
        return {k: np.asarray(v) for k, v in batch.items()}


def mlm_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The argmax's share of right answers over the labelled positions."""
    with torch.no_grad():
        valid = labels != -100
        right = ((logits.argmax(-1) == labels) & valid).sum()
        return right / valid.sum().clamp(min=1)


class MaskedLMModule(TrainModule):
    """A pretraining module over a port model that holds its weights.
    ``convert`` names the family's converter module (its
    ``torch_to_params`` reads an HF state dict)."""

    convert = ""

    def __init__(self, args, model: torch.nn.Module, config):
        super().__init__(args)
        self.model = model
        self.config = config

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("MLM pretrain")
        parser.add_argument("--masked_lm_prob", type=float, default=0.15)
        parser.add_argument("--max_seq_length", type=int, default=512)
        return parent_parser

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        """Weights drawn from ``generator``, then those of
        ``--model_path``'s HF checkpoint when it holds one (a head the
        checkpoint lacks keeps its drawn weights)."""
        from fengshen_tpu_torch.examples.wenzhong_qa.finetune_wenzhong \
            import has_weights
        from fengshen_tpu_torch.utils.convert_common import read_hf_state
        init_weights(self.model, generator, self.config.initializer_range)
        path = getattr(self.args, "model_path", None)
        if has_weights(path):
            convert = importlib.import_module(self.convert)
            state = convert.torch_to_params(read_hf_state(path), self.config)
            missing, _ = self.model.load_state_dict(state, strict=False)
            if missing:
                logger.info("%s holds no %s; drawn weights kept", path,
                            missing)
        return self.model

    def forward(self, batch: dict, **inputs):
        gen = self.dropout_generator
        return self.model(batch["input_ids"],
                          attention_mask=batch["attention_mask"],
                          deterministic=gen is None, dropout_rng=gen,
                          **inputs)

    def training_loss(self, batch: dict) -> tuple:
        logits = self.forward(batch,
                              token_type_ids=batch.get("token_type_ids"))
        loss, n_tokens = vocab_parallel_cross_entropy(logits,
                                                      batch["labels"])
        return loss, {"mlm_acc": mlm_accuracy(logits, batch["labels"]),
                      "n_tokens": n_tokens}


class BertPretrainModule(MaskedLMModule):
    """MLM CE on ``BertForMaskedLM`` (:102)."""

    convert = "fengshen_tpu_torch.models.bert.convert"

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Bert pretrain")
        parser.add_argument("--masked_lm_prob", type=float, default=0.15)
        parser.add_argument("--max_ngram", type=int, default=3)
        parser.add_argument("--max_seq_length", type=int, default=512)
        return parent_parser


def pretrain_parser(module_cls) -> argparse.ArgumentParser:
    """The module, Trainer, data and checkpoint flags of the MLM
    pretraining examples, then ``module_cls``'s own."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    parser = argparse.ArgumentParser()
    parser = add_module_args(parser)
    parser = add_trainer_args(parser)
    parser = UniversalDataModule.add_data_specific_args(parser)
    parser = UniversalCheckpoint.add_argparse_args(parser)
    return module_cls.add_module_specific_args(parser)


def fit(args, module_cls, model_cls, config_cls, tokenizer, make_collator):
    """Build the Trainer (its device first: ``cuda`` raises without a
    card), the tokenizer (``--model_path``'s unless given), the
    collator, the datamodule over ``--train_file`` and the model from
    ``--model_path``'s config on the Trainer's device; fit and return
    the Trainer."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=make_collator(tokenizer),
                                     args=args)
    config = config_cls.from_pretrained(args.model_path)
    model = model_cls(config, device=trainer.device, init=False)
    module = module_cls(args, model, config)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


def main(argv=None, tokenizer=None, word_cuter=None):
    """Fit over ``--train_file``; return the Trainer."""
    from fengshen_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    args = pretrain_parser(BertPretrainModule).parse_args(argv)
    return fit(args, BertPretrainModule, BertForMaskedLM, BertConfig,
               tokenizer, lambda tok: WWMBertCollator(
                   tok, max_seq_length=args.max_seq_length,
                   mask_rate=args.masked_lm_prob, max_ngram=args.max_ngram,
                   word_cuter=word_cuter))


if __name__ == "__main__":
    main()
