"""Ziya-LLaMA SFT: the port of
``fengshen_tpu/examples/ziya_llama/finetune_ziya_llama.py``.

Ported: ``LlamaSFTCollator`` (:30, the ``<human>:`` / ``<bot>:`` prompt
format, -100 prompt labels, right padding), ``LlamaSFTPackedCollator``
(:61, greedy packing into rows of segment ids 1..n with restarting
positions, ``fixed_rows`` and its dropped-rows count), the ``Llama``
module (:147: ``setup`` loads a ``--model_path`` holding weights through
``load_hf_pretrained``'s loader, ``init_params`` keeps them in
``param_dtype``, ``predict_step``) and ``main`` (:193: the datamodule
with the padded or packed collator, ``--lora_rank`` through
``maybe_wrap_lora``, the Trainer with the ``UniversalCheckpoint``
callback). The tokenizer is the caller's; without one ``main`` loads
``AutoTokenizer.from_pretrained(--model_path)`` (``transformers`` is
imported there only). Not yet ported: ``--offload_params`` (ROADMAP.md
queue 1 item 10).

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.ziya_llama.finetune_ziya_llama \\
        --model_path <hf-llama-dir> --train_file sft.jsonl \\
        --val_file val.jsonl --packed --packed_rows 4 \\
        --max_seq_length 1024 --lora_rank 8 --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --every_n_train_steps 100 \\
        --val_check_interval 100 --limit_val_batches 8
"""

from __future__ import annotations

import argparse
import logging
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from fengshen_tpu_torch.trainer.modules import (CausalLMModule,
                                                add_lora_args,
                                                maybe_wrap_lora)

_NOT_PORTED = "is not yet ported in fengshen_tpu_torch"
#: files that make a ``--model_path`` a checkpoint directory (:267)
WEIGHT_FILES = ("pytorch_model.bin", "model.safetensors",
                "pytorch_model.bin.index.json",
                "model.safetensors.index.json")


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


@dataclass
class LlamaSFTPackedCollator:
    """Sequence packing: samples fill rows of ``max_seq_length`` greedily.
    ``attention_mask`` holds per-example segment ids (1..n per row, 0 =
    pad) and ``position_ids`` restart at 0 per example, the contract of
    ``packed_sequences=True``. Prompts and pads are -100, so the shift by
    one across two examples lands on the next prompt's first token and
    no token leaks across examples.

    ``fixed_rows`` pins the row count (all-pad rows added, overflow rows
    dropped): every batch has one shape. Dropped rows are counted in
    ``dropped_rows`` and warned of on the first drop and at every
    hundredth."""

    tokenizer: Any
    max_seq_length: int = 1024
    prompt_key: str = "query"
    answer_key: str = "answer"
    fixed_rows: Any = None

    def _encode(self, s: dict) -> tuple[list, list]:
        eos_id = self.tokenizer.eos_token_id
        prompt = f"<human>:{s[self.prompt_key].strip()}\n<bot>:"
        prompt_ids = self.tokenizer.encode(prompt)
        answer_ids = self.tokenizer.encode(
            s[self.answer_key], add_special_tokens=False)
        if eos_id is not None:
            answer_ids = answer_ids + [eos_id]
        ids = (prompt_ids + answer_ids)[: self.max_seq_length]
        labels = ([-100] * len(prompt_ids) + answer_ids)[
            : self.max_seq_length]
        return ids, labels

    def __call__(self, samples: list[dict]) -> dict:
        pad_id = self.tokenizer.pad_token_id or 0
        rows, cur = [], {"ids": [], "labels": [], "segs": [], "pos": []}
        seg = 1
        for s in samples:
            ids, labels = self._encode(s)
            if cur["ids"] and \
                    len(cur["ids"]) + len(ids) > self.max_seq_length:
                rows.append(cur)
                cur = {"ids": [], "labels": [], "segs": [], "pos": []}
                seg = 1
            cur["ids"] += ids
            cur["labels"] += labels
            cur["segs"] += [seg] * len(ids)
            cur["pos"] += list(range(len(ids)))
            seg += 1
        if cur["ids"]:
            rows.append(cur)
        if self.fixed_rows is not None:
            if len(rows) > self.fixed_rows:
                prev = getattr(self, "dropped_rows", 0)
                self.dropped_rows = prev + len(rows) - self.fixed_rows
                if prev == 0 or prev // 100 != self.dropped_rows // 100:
                    logging.getLogger("fengshen_tpu_torch").warning(
                        "[packed] dropped %d overflow row(s) so far — "
                        "batches pack into more than --packed_rows=%d "
                        "rows; raise it to keep all data",
                        self.dropped_rows, self.fixed_rows)
            rows = rows[: self.fixed_rows]
            empty = {"ids": [], "labels": [], "segs": [], "pos": []}
            rows += [empty] * (self.fixed_rows - len(rows))

        batch = {"input_ids": [], "attention_mask": [], "labels": [],
                 "position_ids": []}
        for r in rows:
            pad = self.max_seq_length - len(r["ids"])
            batch["input_ids"].append(r["ids"] + [pad_id] * pad)
            batch["attention_mask"].append(r["segs"] + [0] * pad)
            batch["labels"].append(r["labels"] + [-100] * pad)
            batch["position_ids"].append(r["pos"] + [0] * pad)
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
        self._weights_path: Optional[str] = None

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Ziya Llama")
        parser.add_argument("--max_seq_length", type=int, default=1024)
        parser.add_argument("--prompt_key", type=str, default="query")
        parser.add_argument("--answer_key", type=str, default="answer")
        parser.add_argument("--packed", action="store_true",
                            help="sequence-pack SFT samples (segment-id "
                                 "attention; no pad FLOPs)")
        parser.add_argument("--packed_rows", type=int, default=None,
                            help="fixed packed-row count per batch")
        parser.add_argument("--offload_params", action="store_true",
                            default=False,
                            help="not yet ported (ROADMAP.md queue 1 "
                                 "item 10)")
        add_lora_args(parser,
                      targets_default=r"(q_proj|k_proj|v_proj|o_proj)")
        parser.add_argument("--offload_moments_dtype", default="param",
                            type=str,
                            choices=["param", "auto", "float32", "bfloat16"])
        return parent_parser

    def setup(self, stage: str = "fit") -> None:
        """A ``--model_path`` holding weights (:267-275) is loaded by
        :meth:`init_params`, tensor by tensor into the model on its
        device; a config-only directory trains from seeded weights."""
        path = getattr(self.args, "model_path", None)
        if path and os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, f))
                for f in WEIGHT_FILES):
            self._weights_path = path

    def init_params(self, generator):
        """The checkpoint's weights (cast to ``param_dtype`` as they are
        copied in), else the seeded weights or the pretrained state dict
        of :class:`CausalLMModule`."""
        if self._weights_path is not None:
            from fengshen_tpu_torch.models.llama.convert import (
                load_hf_weights)
            load_hf_weights(self._weights_path, self.model)
            return self.model
        return super().init_params(generator)

    def predict_step(self, batch: dict, **gen_kwargs):
        """Greedy or sampled generation over a left-padded batch
        (:155-176 -> ``utils.generate``)."""
        from fengshen_tpu_torch.utils.generate import generate
        return generate(self.model, batch["input_ids"],
                        attention_mask=batch.get("attention_mask"),
                        eos_token_id=self.config.eos_token_id,
                        pad_token_id=self.config.pad_token_id,
                        device=self.model.device, **gen_kwargs)


def _refuse_unported(args) -> None:
    if args.offload_params:
        raise NotImplementedError(
            f"--offload_params {_NOT_PORTED} (ROADMAP.md queue 1 item 10)")


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
    parser = Llama.add_module_specific_args(parser)
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
    _refuse_unported(args)
    # the Trainer first: it resolves the device, which raises without a
    # card unless the CPU is asked for, before anything is loaded
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.pipelines.text_generation import (
            auto_tokenizer)
        tokenizer = auto_tokenizer(args.model_path)
    if args.packed:
        # one row count for every batch; ~2x packing assumed when none
        # is given, overflow rows dropped and counted
        rows = args.packed_rows or max(1, args.train_batchsize // 2)
        collator = LlamaSFTPackedCollator(
            tokenizer, max_seq_length=args.max_seq_length,
            prompt_key=args.prompt_key, answer_key=args.answer_key,
            fixed_rows=rows)
    else:
        collator = LlamaSFTCollator(tokenizer,
                                    max_seq_length=args.max_seq_length,
                                    prompt_key=args.prompt_key,
                                    answer_key=args.answer_key)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    module = Llama(args, device=trainer.device)
    if args.packed:
        module.config.packed_sequences = True
    module = maybe_wrap_lora(module, args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
