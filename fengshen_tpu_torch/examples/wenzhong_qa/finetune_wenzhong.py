"""Wenzhong-GPT2 QA fine-tune: the port of
``fengshen_tpu/examples/wenzhong_qa/finetune_wenzhong.py``, which both
Wenzhong shells run (``finetune_GPT2_medicalQA.sh`` and
``finetune_wenzhong.sh``).

Ported: ``WenzhongQACollator`` (:21-44: ``"Question:{q} Answer:"``,
``eos`` appended to the answer, -100 labels over the question and the
padding, right padding with ``pad_token_id or 0``), the ``Wenzhong``
module (:47, a ``CausalLMModule`` over ``GPT2LMHeadModel``: the loss
mode "off", or the fused LM-head CE through kernel K2 under GPT-2's tied
head with ``fused_ce_chunks`` > 0) and ``main`` (:61: the datamodule
with the collator, the Trainer with the ``UniversalCheckpoint``
callback). The tokenizer is the caller's; without one ``main`` loads
``AutoTokenizer.from_pretrained(--model_path)`` (``transformers`` is
imported there only).

One difference from the JAX package: its ``Wenzhong`` reads only the
config from ``--model_path`` and trains from random weights; the port's
loads a ``--model_path`` that holds weights (``*.safetensors`` or
``pytorch_model*.bin``), as the reference's ``GPT2LMHeadModel
.from_pretrained`` does. ``finetune_wenzhong.sh`` passes
``--offload_optimizer``, which the Trainer refuses (ROADMAP.md queue 1
item 10).

Run (on the card; ``--device cpu`` for the CPU), with the medicalQA
shell's flags:
    python -m fengshen_tpu_torch.examples.wenzhong_qa.finetune_wenzhong \\
        --model_path <hf-gpt2-dir> --train_file train.json \\
        --val_file dev.json --save_ckpt_path ckpt --load_ckpt_path ckpt \\
        --train_batchsize 1 --max_seq_length 512 --learning_rate 1e-5 \\
        --weight_decay 1e-2 --adam_beta2 0.95 --gradient_clip_val 1.0 \\
        --precision bf16
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from fengshen_tpu_torch.trainer.modules import CausalLMModule


@dataclass
class WenzhongQACollator:
    tokenizer: Any
    max_seq_length: int = 512
    question_key: str = "question"
    answer_key: str = "answer"

    def __call__(self, samples: list[dict]) -> dict:
        batch = {"input_ids": [], "attention_mask": [], "labels": []}
        pad_id = self.tokenizer.pad_token_id or 0
        eos_id = self.tokenizer.eos_token_id
        for s in samples:
            text = f"Question:{s[self.question_key]} Answer:"
            q_ids = self.tokenizer.encode(text, add_special_tokens=False)
            a_ids = self.tokenizer.encode(str(s[self.answer_key]),
                                          add_special_tokens=False)
            if eos_id is not None:
                a_ids = a_ids + [eos_id]
            ids = (q_ids + a_ids)[: self.max_seq_length]
            labels = ([-100] * len(q_ids) + a_ids)[: self.max_seq_length]
            pad = self.max_seq_length - len(ids)
            batch["input_ids"].append(ids + [pad_id] * pad)
            batch["attention_mask"].append([1] * len(ids) + [0] * pad)
            batch["labels"].append(labels + [-100] * pad)
        return {k: np.asarray(v) for k, v in batch.items()}


def has_weights(path: Optional[str]) -> bool:
    """Does ``path`` hold an HF checkpoint's weights?"""
    from fengshen_tpu_torch.utils.convert_common import checkpoint_files
    if not path or not os.path.isdir(path):
        return False
    try:
        checkpoint_files(path)
    except FileNotFoundError:
        return False
    return True


class Wenzhong(CausalLMModule):
    """The QA module: a GPT-2 causal LM on ``device`` (``None`` =
    ``cuda``, raising without a card)."""

    def __init__(self, args, config: Optional[GPT2Config] = None,
                 device=None):
        if config is None and getattr(args, "model_path", None):
            config = GPT2Config.from_pretrained(args.model_path)
        if config is None:
            raise ValueError("Wenzhong needs a config or --model_path")
        # init_params writes every weight (drawn or loaded)
        model = GPT2LMHeadModel(config, device=device, init=False)
        super().__init__(args, model, config)

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Wenzhong QA")
        parser.add_argument("--max_seq_length", type=int, default=512)
        return parent_parser

    def init_params(self, generator):
        """The ``--model_path`` checkpoint's weights (cast to
        ``param_dtype`` as they are copied in) when it holds any, else
        the seeded weights or the pretrained state dict of
        :class:`CausalLMModule`."""
        path = getattr(self.args, "model_path", None)
        if self.pretrained_state is None and has_weights(path):
            from fengshen_tpu_torch.models.gpt2.convert import (
                load_hf_weights)
            load_hf_weights(path, self.model)
            return self.model
        return super().init_params(generator)


def parse_args(argv=None) -> argparse.Namespace:
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
    parser = Wenzhong.add_module_specific_args(parser)
    return parser.parse_args(argv)


def main(argv=None, tokenizer=None):
    """Fine-tune; returns the Trainer (its ``state`` and its logged
    ``history``). ``tokenizer`` defaults to the ``--model_path``
    directory's, through ``AutoTokenizer``."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = parse_args(argv)
    # the Trainer first: it refuses what is not ported and resolves the
    # device (which raises without a card unless the CPU is asked for)
    # before anything is loaded
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.pipelines.text_generation import (
            auto_tokenizer)
        tokenizer = auto_tokenizer(args.model_path)
    collator = WenzhongQACollator(tokenizer,
                                  max_seq_length=args.max_seq_length)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    module = Wenzhong(args, device=trainer.device)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
