"""Ziya-LLaMA SFT: the port of
``fengshen_tpu/examples/ziya_llama/finetune_ziya_llama.py``.

Ported: ``LlamaSFTCollator`` (:30, the ``<human>:`` / ``<bot>:`` prompt
format, -100 prompt labels, right padding), the ``Llama`` module (:147)
and ``main`` (the padded path: Trainer.fit over the datamodule). The
model runs the configuration ``--model_path`` names (a LLaMA
``config.json`` or its directory); the weights are made on the device
from ``--seed``, since checkpoint loading is not yet ported; the
tokenizer is the caller's or the ``IdTokenizer`` stand-in (never
``AutoTokenizer``). Not yet ported: ``--packed``, ``--offload_params``,
LoRA (``--lora_rank``) and checkpointing.

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.ziya_llama.finetune_ziya_llama \\
        --model_path workspace/ziya-llama-13b --train_file sft.jsonl \\
        --train_batchsize 4 --max_seq_length 1024 --max_steps 6
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from fengshen_tpu_torch.trainer.modules import CausalLMModule

_NOT_PORTED = "is not yet ported in fengshen_tpu_torch"


@dataclass
class LlamaSFTCollator:
    """Prompt ``'<human>:{q}\\n<bot>:{a}'``, prompt tokens label-masked to
    -100, right-padded to ``max_seq_length``."""

    tokenizer: Any
    max_seq_length: int = 1024
    prompt_key: str = "query"
    answer_key: str = "answer"

    def __call__(self, samples: list[dict]) -> dict:
        batch = {"input_ids": [], "attention_mask": [], "labels": []}
        pad_id = self.tokenizer.pad_token_id or 0
        eos_id = self.tokenizer.eos_token_id
        for s in samples:
            prompt = f"<human>:{s[self.prompt_key].strip()}\n<bot>:"
            prompt_ids = self.tokenizer.encode(prompt)
            answer_ids = self.tokenizer.encode(
                s[self.answer_key], add_special_tokens=False)
            if eos_id is not None:
                answer_ids = answer_ids + [eos_id]
            ids = (prompt_ids + answer_ids)[: self.max_seq_length]
            labels = ([-100] * len(prompt_ids) + answer_ids)[
                : self.max_seq_length]
            pad = self.max_seq_length - len(ids)
            batch["input_ids"].append(ids + [pad_id] * pad)
            batch["attention_mask"].append([1] * len(ids) + [0] * pad)
            batch["labels"].append(labels + [-100] * pad)
        return {k: np.asarray(v) for k, v in batch.items()}


class Llama(CausalLMModule):
    """The SFT module: a LLaMA causal LM on ``device`` (``None`` =
    ``cuda``, raising without a card)."""

    def __init__(self, args, config: Optional[LlamaConfig] = None,
                 device=None):
        if config is None and getattr(args, "model_path", None):
            config = LlamaConfig.from_pretrained(args.model_path)
        if config is None:
            raise ValueError("Llama needs a config or --model_path")
        model = LlamaForCausalLM(config, device=device)
        super().__init__(args, model, config)

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Ziya Llama")
        parser.add_argument("--max_seq_length", type=int, default=1024)
        parser.add_argument("--prompt_key", type=str, default="query")
        parser.add_argument("--answer_key", type=str, default="answer")
        parser.add_argument("--packed", action="store_true")
        parser.add_argument("--packed_rows", type=int, default=None)
        parser.add_argument("--offload_params", action="store_true",
                            default=False)
        parser.add_argument("--offload_moments_dtype", default="param",
                            type=str,
                            choices=["param", "auto", "float32", "bfloat16"])
        parser.add_argument("--lora_rank", default=0, type=int)
        parser.add_argument("--lora_alpha", default=None, type=float)
        parser.add_argument("--lora_targets",
                            default=r"(q_proj|k_proj|v_proj|o_proj)",
                            type=str)
        parser.add_argument("--lora_train_modules", default=None, type=str)
        return parent_parser

    def setup(self, stage: str = "fit") -> None:
        """A ``--model_path`` holding checkpoint weights would load them
        here; checkpoint loading is not yet ported, so such a directory
        is refused rather than trained from random weights."""
        import os
        path = getattr(self.args, "model_path", None)
        if path and os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, f))
                for f in ("pytorch_model.bin", "model.safetensors",
                          "pytorch_model.bin.index.json",
                          "model.safetensors.index.json")):
            raise NotImplementedError(
                f"loading the checkpoint in {path} {_NOT_PORTED}")


def _refuse_unported(args) -> None:
    for flag, on in (("--packed", args.packed),
                     ("--offload_params", args.offload_params),
                     ("--lora_rank", args.lora_rank)):
        if on:
            raise NotImplementedError(f"{flag} {_NOT_PORTED}")


def parse_args(argv=None) -> argparse.Namespace:
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args

    parser = argparse.ArgumentParser()
    parser = add_module_args(parser)
    parser = add_trainer_args(parser)
    parser = UniversalDataModule.add_data_specific_args(parser)
    parser = Llama.add_module_specific_args(parser)
    return parser.parse_args(argv)


def main(argv=None, tokenizer=None):
    """Fine-tune; returns the Trainer (its ``state`` and its logged
    ``history``)."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
    from fengshen_tpu_torch.trainer import Trainer

    args = parse_args(argv)
    _refuse_unported(args)
    tokenizer = tokenizer if tokenizer is not None else IdTokenizer()
    collator = LlamaSFTCollator(tokenizer,
                                max_seq_length=args.max_seq_length,
                                prompt_key=args.prompt_key,
                                answer_key=args.answer_key)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    trainer = Trainer(args)
    module = Llama(args, device=trainer.device)
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
