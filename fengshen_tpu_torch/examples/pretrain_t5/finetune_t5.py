"""UniMC-format multiple choice over T5 (Randeng-T5-Char-57M): the port
of ``fengshen_tpu/examples/pretrain_t5/finetune_t5.py`` (driven by
``finetune_unimc_randeng_t5_char_57M.sh``).

Each UniMC row ``{texta, textb, question, choice, answer, label}``
becomes ``question + '，'.join(choice) + '。' + texta [+ textb]`` (the
source, through the tokenizer's ``__call__`` padded to
``--max_seq_length``) and its answer text (the target, at most
``MAX_ANSWER_LEN`` tokens ending in eos), trained with seq2seq CE
(:class:`TaskT5Collator`, :class:`MT5FinetuneModule`). Validation also
scores every option's tokens by teacher-forced mean log-likelihood in
one batched forward over ``--max_choices`` options a row and takes the
argmax (``cond_acc``), as the JAX package does in place of the
reference's constrained beam.

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.pretrain_t5.finetune_t5 \\
        --pretrained_model_path <randeng-t5-char-57M> \\
        --tokenizer_type bert_tokenizer --train_data_path train.json \\
        --valid_data_path dev.json --max_seq_length 512 \\
        --train_batchsize 8 --max_steps 1000
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqModule, common_parser)

MAX_ANSWER_LEN = 16


class TaskT5Dataset:
    """The jsonl rows of ``data_path`` (:35)."""

    def __init__(self, data_path: str, args):
        self.max_length = args.max_seq_length
        with open(data_path, encoding="utf8") as f:
            self.data = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


def encode_text(item: dict) -> str:
    """The source text of a UniMC row (:52)."""
    if item.get("textb"):
        return (item["question"] + "，".join(item["choice"]) + "。" +
                str(item["texta"]) + str(item["textb"]))
    return (str(item["question"]) + "，".join(item["choice"]) + "。" +
            str(item["texta"]))


@dataclass
class TaskT5Collator:
    """UniMC rows -> the seq2seq batch plus ``choice_ids [B, C, L]``
    (-100 past each option), ``choice_mask [B, C]`` and ``label_idx``
    (:60)."""

    tokenizer: Any
    max_seq_length: int = 512
    decoder_start_token_id: int = 0
    max_choices: int = 16

    def _encode_answer(self, text: str) -> list:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        eos = self.tokenizer.eos_token_id
        if eos is not None:
            ids = ids[: MAX_ANSWER_LEN - 1] + [eos]
        return ids[:MAX_ANSWER_LEN]

    def __call__(self, samples: list) -> dict:
        pad = self.tokenizer.pad_token_id or 0
        batch = {"input_ids": [], "attention_mask": [],
                 "decoder_input_ids": [], "labels": [],
                 "choice_ids": [], "choice_mask": [], "label_idx": []}
        for item in samples:
            enc = self.tokenizer(
                encode_text(item), max_length=self.max_seq_length,
                padding="max_length", truncation=True)
            batch["input_ids"].append(enc["input_ids"])
            batch["attention_mask"].append(enc["attention_mask"])
            tgt = self._encode_answer(item.get("answer", ""))
            dec_in = [self.decoder_start_token_id] + tgt[:-1]
            pad_t = MAX_ANSWER_LEN - len(tgt)
            batch["decoder_input_ids"].append(dec_in + [pad] * pad_t)
            batch["labels"].append(tgt + [-100] * pad_t)
            cids = np.full((self.max_choices, MAX_ANSWER_LEN), -100,
                           np.int32)
            cmask = np.zeros((self.max_choices,), np.int32)
            for c, choice in enumerate(item["choice"][: self.max_choices]):
                ids = self._encode_answer(choice)
                cids[c, : len(ids)] = ids
                cmask[c] = 1
            batch["choice_ids"].append(cids)
            batch["choice_mask"].append(cmask)
            batch["label_idx"].append(int(item.get("label", 0)))
        return {k: np.asarray(v) for k, v in batch.items()}


class MT5FinetuneModule(Seq2SeqModule):
    """Seq2seq CE, and the choice decision in validation (:112)."""

    @staticmethod
    def add_model_specific_args(parent_args):
        parser = parent_args.add_argument_group("BaseModel")
        parser.add_argument("--keep_tokens_path", default=None, type=str)
        parser.add_argument("--max_seq_length", default=512, type=int)
        parser.add_argument(
            "--tokenizer_type", default="t5_tokenizer", type=str,
            choices=["t5_tokenizer", "bert_tokenizer"])
        parser.add_argument("--pretrained_model_path", default=None,
                            type=str)
        parser.add_argument("--train_data_path", default=None, type=str)
        parser.add_argument("--valid_data_path", default=None, type=str)
        parser.add_argument("--max_choices", default=16, type=int)
        return parent_args

    def validation_loss(self, batch: dict) -> tuple:
        """The CE, and ``cond_acc``: the share of rows whose best-scored
        option (mean log-probability of its tokens, teacher-forced
        behind ``decoder_start_token_id``) is ``label_idx`` (:162)."""
        with torch.no_grad():
            loss, _ = self.training_loss(batch)
            choice = batch["choice_ids"]
            rows, n_choices, length = choice.shape
            flat = choice.reshape(rows * n_choices, length)
            start = torch.full((rows * n_choices, 1),
                               self.config.decoder_start_token_id,
                               dtype=flat.dtype, device=flat.device)
            dec_in = torch.cat(
                [start, torch.where(flat[:, :-1] < 0, 0, flat[:, :-1])], 1)
            logits = self.model(
                batch["input_ids"].repeat_interleave(n_choices, 0), dec_in,
                attention_mask=batch["attention_mask"].repeat_interleave(
                    n_choices, 0))
            logp = torch.log_softmax(logits.float(), -1)
            tok_lp = logp.gather(
                -1, flat.clamp(min=0)[..., None].long())[..., 0]
            valid = (flat >= 0).float()
            scores = (tok_lp * valid).sum(-1) / valid.sum(-1).clamp(min=1)
            scores = torch.where(batch["choice_mask"] > 0,
                                 scores.reshape(rows, n_choices),
                                 torch.full_like(scores[:1], -1e9))
            acc = (scores.argmax(-1) == batch["label_idx"]).float().mean()
        return loss, {"cond_acc": acc}

    def sequence_lengths(self) -> tuple:
        return int(self.args.max_seq_length), MAX_ANSWER_LEN


def main(argv=None, tokenizer=None):
    """Fit; return the Trainer. ``tokenizer`` defaults to
    ``--tokenizer_type``'s of ``--pretrained_model_path``."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.examples.pretrain_t5.pretrain_t5 import \
        load_tokenizer
    from fengshen_tpu_torch.models.t5 import (T5Config,
                                              T5ForConditionalGeneration)
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    parser = MT5FinetuneModule.add_model_specific_args(
        common_parser("Finetune T5 (UniMC format)"))
    args = parser.parse_args(argv)
    args.model_path = args.pretrained_model_path
    trainer = Trainer(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args)
    config = T5Config.from_pretrained(args.pretrained_model_path)
    model = T5ForConditionalGeneration(config, device=trainer.device,
                                       init=False)
    module = MT5FinetuneModule(args, model, config)
    collator = TaskT5Collator(
        tokenizer, max_seq_length=args.max_seq_length,
        decoder_start_token_id=config.decoder_start_token_id,
        max_choices=args.max_choices)
    datasets = {"train": TaskT5Dataset(args.train_data_path, args)}
    if args.valid_data_path:
        datasets["validation"] = TaskT5Dataset(args.valid_data_path, args)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args,
                                     datasets=datasets)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
