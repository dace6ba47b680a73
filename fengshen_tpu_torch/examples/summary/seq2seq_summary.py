"""Seq2seq summarization fine-tune: the port of
``fengshen_tpu/examples/summary/seq2seq_summary.py``, the script behind
the reference's ``randeng_t5_*_summary.sh``, ``randeng_pegasus_523M_
summary.sh`` and ``pretrain_bart_summary.sh`` shells (LCSTS-style
``{text, summary}`` records; T5, BART or Pegasus by ``--model_type``).

Ported: :class:`Seq2SeqCollator` (:23-68: the prompt, truncation, eos,
the decoder input shifted behind ``decoder_start_token_id``, fixed-length
padding, -100 labels), :class:`Seq2SeqModule` (:71-102: teacher-forced
CE over the materialised logits; ``predict_step`` decodes through
``utils/generate.seq2seq_predict_step``, greedy or beam by
``--num_beams``), :func:`build_model` (:105-125), :func:`main` (:128-205,
with the shells' aliases ``--pretrained_model_path``,
``--max_enc_length``, ``--max_dec_length``, and ``--do_eval_only``) and
:func:`evaluate_and_save` (:208-241: one pass over the materialised test
batches into ``--output_save_path``, one ``{"pred": ...}`` line a row,
then char-level ROUGE, printed and logged). ``--datasets_name`` is
refused by the datamodule (ROADMAP.md queue 1 item 8): pass
``--train_file``, ``--val_file`` and ``--test_file``.

Port differences, as in the other ported examples: the model drops out
with the per-step generator the Trainer hands the module
(``ops/dropout.py``), and validation and prediction run deterministic
(the reference's validation reuses the training loss, dropout on);
``--model_path`` holding weights (``*.safetensors`` or
``pytorch_model*.bin``) loads them, as the reference's
``from_pretrained`` does, where the JAX package reads only the config;
the tokenizer is the caller's, or ``models/auto.AutoTokenizer`` of
``--model_path`` (``transformers`` imported there only); after the fit
the prediction runs on the best ``--monitor`` checkpoint when the
callback ranked any, the one ``--do_eval_only`` restores
(``utils/universal_checkpoint.py``); ``--lora_targets`` matches the
port's module paths (``model/encoder/block_0/self_attention/q``).

Run (on the card; ``--device cpu`` for the CPU), as the Randeng-T5-784M
shell (``randeng_t5_784M_summary.sh``) with local files:
    python -m fengshen_tpu_torch.examples.summary.seq2seq_summary \\
        --model_type t5 --pretrained_model_path <randeng-t5-dir> \\
        --train_file train.json --val_file val.json --test_file test.json \\
        --output_save_path predict.json --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --monitor val_loss --mode min \\
        --save_top_k 3 --save_last --train_batchsize 64 \\
        --val_batchsize 64 --test_batchsize 64 --max_enc_length 128 \\
        --max_dec_length 64 --prompt "" --learning_rate 1e-4 \\
        --weight_decay 1e-2 --max_epochs 1 --precision bf16
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)
from fengshen_tpu_torch.trainer.module import TrainModule

#: the module paths ``--lora_rank`` adapts by default: every attention
#: projection, self and cross, of the three families
LORA_TARGETS = (r"(self_attention|cross_attention|self_attn|encoder_attn)"
                r"/(q|k|v|o|q_proj|k_proj|v_proj|out_proj)$")


@dataclass
class Seq2SeqCollator:
    """Generic seq2seq batching (encode, truncate, eos, the shifted
    decoder input, fixed-length padding). Task collators override
    ``source_text`` / ``target_text`` only."""

    tokenizer: Any
    max_src_length: int = 512
    max_tgt_length: int = 128
    decoder_start_token_id: int = 0
    text_key: str = "text"
    summary_key: str = "summary"
    #: task prefix prepended to the source (``--prompt``)
    prompt: str = ""

    def source_text(self, sample: dict) -> str:
        return self.prompt + sample[self.text_key]

    def target_text(self, sample: dict) -> str:
        return sample[self.summary_key]

    def __call__(self, samples: list) -> dict:
        pad = self.tokenizer.pad_token_id or 0
        eos = self.tokenizer.eos_token_id
        batch = {"input_ids": [], "attention_mask": [],
                 "decoder_input_ids": [], "labels": []}
        for s in samples:
            src = self.tokenizer.encode(self.source_text(s),
                                        add_special_tokens=False
                                        )[: self.max_src_length - 1]
            if eos is not None:
                src = src + [eos]
            tgt = self.tokenizer.encode(self.target_text(s),
                                        add_special_tokens=False
                                        )[: self.max_tgt_length - 1]
            if eos is not None:
                tgt = tgt + [eos]
            dec_in = [self.decoder_start_token_id] + tgt[:-1]
            ps = self.max_src_length - len(src)
            pt = self.max_tgt_length - len(tgt)
            batch["input_ids"].append(src + [pad] * ps)
            batch["attention_mask"].append([1] * len(src) + [0] * ps)
            batch["decoder_input_ids"].append(dec_in + [pad] * pt)
            batch["labels"].append(tgt + [-100] * pt)
        return {k: np.asarray(v) for k, v in batch.items()}


def _side(name: str) -> Optional[str]:
    """``"encoder"`` or ``"decoder"`` for a parameter of that stack's
    layers (``model.encoder.block_0...``, ``encoder_layer_0...``)."""
    for seg in name.split("."):
        for side in ("encoder", "decoder"):
            if seg == side or seg.startswith(f"{side}_layer_"):
                return side
    return None


def _depths(config) -> tuple:
    """``(encoder layers, decoder layers, attention width)``."""
    if hasattr(config, "num_layers"):           # T5
        return (config.num_layers, config.num_decoder_layers,
                config.num_heads * config.d_kv)
    return config.encoder_layers, config.decoder_layers, config.d_model


class Seq2SeqModule(TrainModule):
    """Teacher-forced seq2seq training (:71): ``model`` is a port
    encoder-decoder holding its weights; ``pretrained_state``, when set,
    is a state dict :meth:`init_params` loads."""

    def __init__(self, args, model, config):
        super().__init__(args)
        self.model = model
        self.config = config
        self.pretrained_state: Optional[dict] = None

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        """The pretrained state dict when one is set, else the weights of
        ``--model_path`` when it holds any, else weights drawn from
        ``generator``."""
        path = getattr(self.args, "model_path", None)
        if self.pretrained_state is not None:
            self.model.load_state_dict(self.pretrained_state)
        elif _has_weights(path):
            _family_convert(self.model).load_hf_weights(path, self.model)
        else:
            self.model.init_weights(generator)
        return self.model

    def _logits(self, batch: dict) -> torch.Tensor:
        gen = self.dropout_generator
        return self.model(batch["input_ids"], batch["decoder_input_ids"],
                          attention_mask=batch["attention_mask"],
                          deterministic=gen is None, dropout_rng=gen)

    def training_loss(self, batch: dict) -> tuple:
        loss, n = vocab_parallel_cross_entropy(self._logits(batch),
                                               batch["labels"])
        return loss, {"n_tokens": n}

    def predict_step(self, batch: dict) -> torch.Tensor:
        """Greedy or beam decode of the batch (:95), ``[B, 1 +
        --max_tgt_length]`` decoder ids."""
        from fengshen_tpu_torch.utils.generate import seq2seq_predict_step
        return seq2seq_predict_step(self.model, self.config, self.args,
                                    batch,
                                    max_new_tokens=self.args.max_tgt_length)

    def tokens_in_batch(self, batch) -> int:
        """Encoder and decoder tokens both (padding included)."""
        return int(np.prod(np.shape(batch["input_ids"]))) + \
            int(np.prod(np.shape(batch["decoder_input_ids"])))

    def sequence_lengths(self) -> tuple:
        """``(S, T)``: the encoder and decoder lengths of a batch
        (``--max_src_length``, ``--max_tgt_length``)."""
        return int(self.args.max_src_length), int(self.args.max_tgt_length)

    def flops_per_token(self) -> float:
        """Forward plus backward FLOPs of one sample over its ``S + T``
        tokens (:meth:`sequence_lengths`): 6 x the
        encoder layers' matrix parameters x S, 6 x (the decoder layers'
        plus the ``d_model x vocab`` head) x T, and attention's 12 x
        width x (encoder layers x S^2 + decoder layers x (T^2 + T x S)),
        divided by ``S + T`` (the tokens :meth:`tokens_in_batch` counts).
        Embedding and position tables and T5's bias tables are left
        out."""
        cfg = self.config
        src, tgt = self.sequence_lengths()
        params = {"encoder": 0, "decoder": 0}
        for name, p in self.model.named_parameters():
            side = _side(name)
            if side and p.dim() >= 2 and "relative_attention_bias" \
                    not in name and "embed_positions" not in name:
                params[side] += p.numel()
        n_enc, n_dec, width = _depths(cfg)
        head = cfg.d_model * cfg.vocab_size
        total = 6.0 * (params["encoder"] * src +
                       (params["decoder"] + head) * tgt) + \
            12.0 * width * (n_enc * src * src +
                            n_dec * (tgt * tgt + tgt * src))
        return total / (src + tgt)


def _has_weights(path: Optional[str]) -> bool:
    from fengshen_tpu_torch.utils.convert_common import checkpoint_files
    if not path or not os.path.isdir(path):
        return False
    try:
        checkpoint_files(path)
    except FileNotFoundError:
        return False
    return True


def _family_convert(model):
    import importlib
    family = type(model).__module__.rsplit(".", 1)[0]
    return importlib.import_module(f"{family}.convert")


def build_model(model_type: str, model_path=None, config=None,
                device=None):
    """``(model, config)`` of ``model_type`` (``t5``, ``bart`` or
    ``pegasus``; :105): the config from ``model_path`` (else the family's
    small test config), the model built on ``device`` (None: ``cuda``)
    with its weights unwritten (``Seq2SeqModule.init_params`` writes
    them)."""
    if model_type == "t5":
        from fengshen_tpu_torch.models.t5 import (T5Config,
                                                  T5ForConditionalGeneration)
        config_cls, model_cls = T5Config, T5ForConditionalGeneration
    elif model_type == "bart":
        from fengshen_tpu_torch.models.bart import (
            BartConfig, BartForConditionalGeneration)
        config_cls, model_cls = BartConfig, BartForConditionalGeneration
    elif model_type == "pegasus":
        from fengshen_tpu_torch.models.pegasus import (
            PegasusConfig, PegasusForConditionalGeneration)
        config_cls, model_cls = PegasusConfig, \
            PegasusForConditionalGeneration
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    config = config or (config_cls.from_pretrained(model_path)
                        if model_path else config_cls.small_test_config())
    return model_cls(config, device=device, init=False), config


def common_parser(description=None) -> argparse.ArgumentParser:
    """The module, Trainer, data and checkpoint flags of every seq2seq
    example."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    parser = argparse.ArgumentParser(description)
    parser = add_module_args(parser)
    parser = add_trainer_args(parser)
    parser = UniversalDataModule.add_data_specific_args(parser)
    return UniversalCheckpoint.add_argparse_args(parser)


def build_parser() -> argparse.ArgumentParser:
    from fengshen_tpu_torch.trainer.modules import add_lora_args

    parser = common_parser()
    group = parser.add_argument_group("summary")
    group.add_argument("--model_type", default="t5", type=str,
                       choices=["t5", "bart", "pegasus"])
    group.add_argument("--max_src_length", default=512, type=int)
    group.add_argument("--max_tgt_length", default=128, type=int)
    group.add_argument("--num_beams", default=1, type=int)
    group.add_argument("--length_penalty", default=1.0, type=float)
    group.add_argument("--repetition_penalty", default=1.0, type=float)
    group.add_argument("--no_repeat_ngram_size", default=0, type=int)
    group.add_argument("--min_length", default=0, type=int)
    group.add_argument("--do_eval_only", action="store_true",
                       default=False)
    group.add_argument("--pretrained_model_path", default=None, type=str,
                       help="alias of --model_path (reference flag name)")
    group.add_argument("--output_save_path", default="./predict.json",
                       type=str)
    group.add_argument("--prompt", default="summarize:", type=str)
    group.add_argument("--rouge_keys", default="rougeL,rouge1,rouge2",
                       type=str)
    group.add_argument("--max_enc_length", default=None, type=int,
                       help="alias of --max_src_length (reference name)")
    group.add_argument("--max_dec_length", default=None, type=int,
                       help="alias of --max_tgt_length (reference name)")
    add_lora_args(parser, targets_default=LORA_TARGETS)
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.pretrained_model_path:
        args.model_path = args.pretrained_model_path
    if args.max_enc_length:
        args.max_src_length = args.max_enc_length
    if args.max_dec_length:
        args.max_tgt_length = args.max_dec_length
    return args


def main(argv=None, tokenizer=None):
    """Fit (or, with ``--do_eval_only``, restore), then decode the test
    split into ``--output_save_path`` and log its ROUGE. Returns the
    Trainer (its ``state`` and logged ``history``, the ROUGE entry
    last). ``tokenizer`` defaults to ``--model_path``'s."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = parse_args(argv)
    # the Trainer first: it refuses what is not ported and resolves the
    # device (which raises without a card unless the CPU is asked for)
    # before anything is loaded
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    model, config = build_model(args.model_type, args.model_path,
                                device=trainer.device)
    collator = Seq2SeqCollator(
        tokenizer, max_src_length=args.max_src_length,
        max_tgt_length=args.max_tgt_length,
        decoder_start_token_id=getattr(config, "decoder_start_token_id", 0),
        prompt=args.prompt)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    module = maybe_wrap_lora(Seq2SeqModule(args, model, config), args)
    ckpt = UniversalCheckpoint(args)
    trainer.callbacks.append(ckpt)
    if args.do_eval_only:
        state = trainer.restore_for_predict(module)
    else:
        state = trainer.fit(module, datamodule)
        if ckpt.best_step() is not None:
            # the best monitored checkpoint predicts, as the one a
            # --do_eval_only run restores
            state = ckpt.maybe_restore(state, trainer, weights_only=True)
    test_loader = datamodule.test_dataloader()
    if test_loader is not None:
        evaluate_and_save(trainer, module, tokenizer, test_loader, args,
                          state)
    return trainer


def evaluate_and_save(trainer, module, tokenizer, loader, args,
                      state) -> dict:
    """Decode the test split, write one ``{"pred": text}`` line a row to
    ``--output_save_path``, print and log char-level ROUGE (:208). One
    pass: the batches are materialised, predicted over, and the
    references taken from the same batches."""
    from fengshen_tpu_torch.metrics.rouge import rouge_scores

    batches = list(loader)
    outputs = trainer.predict(module, batches, state=state)
    preds, refs = [], []
    with open(args.output_save_path, "w", encoding="utf-8") as f:
        for batch, out in zip(batches, outputs):
            tokens = out.detach().cpu().numpy()
            texts = tokenizer.batch_decode(tokens, skip_special_tokens=True)
            preds.extend(texts)
            for t in texts:
                f.write(json.dumps({"pred": t}, ensure_ascii=False) + "\n")
            labels = np.where(batch["labels"] < 0, 0, batch["labels"])
            refs.extend(tokenizer.batch_decode(
                labels, skip_special_tokens=True))
    keys = tuple(k.strip() for k in args.rouge_keys.split(","))
    scores = rouge_scores(preds, refs, keys=keys)
    print("rouge:", json.dumps(scores, ensure_ascii=False))
    trainer._log({"event": "rouge", "rows": len(preds), **scores})
    return scores


if __name__ == "__main__":
    main()
