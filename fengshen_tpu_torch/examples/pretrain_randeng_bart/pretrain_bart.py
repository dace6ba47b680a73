"""Randeng-BART text-infilling pretraining over an indexed corpus: the
port of ``fengshen_tpu/examples/pretrain_randeng_bart/pretrain_bart.py``
(driven by ``pretrain_bart.sh`` and ``pretrain_bart_base.sh``).

Samples come from ``data/megatron_dataloader.BartDataset`` over the
``MMapIndexedDataset`` at ``--data_prefix`` (sentence permutation and
Poisson whole-word infilling); :class:`BartPretrainModule` feeds the
clean labels shifted right behind ``decoder_start_token_id`` (-100
read as the pad id) to the decoder and takes CE over them.
``main(zh_tokenizer=...)`` hands the dataset its word segmenter: None
(the default) means ``jieba``, ``False`` the wordpiece grouping.

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.pretrain_randeng_bart.pretrain_bart \\
        --model_path <randeng-bart-139M> --data_prefix corpus \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 16 --max_steps 100000 \\
        --learning_rate 2e-5 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 --max_seq_length 512
"""

from __future__ import annotations

import numpy as np
import torch

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqModule, common_parser)
from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)


class BartPretrainModule(Seq2SeqModule):
    """Denoising CE (:25)."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("bart pretrain")
        parser.add_argument("--data_prefix", type=str, default=None,
                            help="MMapIndexedDataset path prefix")
        parser.add_argument("--max_seq_length", type=int, default=512)
        parser.add_argument("--masked_lm_prob", type=float, default=0.15)
        return parent_parser

    def decoder_inputs(self, labels: torch.Tensor) -> torch.Tensor:
        """``labels`` shifted right behind ``decoder_start_token_id``,
        -100 read as the pad id (:47)."""
        cfg = self.config
        safe = torch.where(labels == -100, getattr(cfg, "pad_token_id", 0),
                           labels)
        start = torch.full((labels.shape[0], 1), cfg.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        return torch.cat([start, safe[:, :-1]], 1)

    def training_loss(self, batch: dict) -> tuple:
        labels = batch["labels"]
        logits = self._logits(dict(batch,
                                   decoder_input_ids=self.decoder_inputs(
                                       labels)))
        loss, n_tokens = vocab_parallel_cross_entropy(logits, labels)
        return loss, {"n_tokens": n_tokens}

    def tokens_in_batch(self, batch) -> int:
        """Encoder and decoder tokens (the labels' length)."""
        return int(np.prod(np.shape(batch["input_ids"]))) + \
            int(np.prod(np.shape(batch["labels"])))

    def sequence_lengths(self) -> tuple:
        return int(self.args.max_seq_length), int(self.args.max_seq_length)


def main(argv=None, tokenizer=None, zh_tokenizer=None):
    """Fit over ``--data_prefix``; return the Trainer. ``tokenizer``
    defaults to ``--model_path``'s."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.data.megatron_dataloader import (
        BartDataset, MMapIndexedDataset)
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import \
        build_model
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = BartPretrainModule.add_module_specific_args(
        common_parser()).parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    dataset = BartDataset(
        MMapIndexedDataset(args.data_prefix), tokenizer,
        max_seq_length=args.max_seq_length,
        masked_lm_prob=args.masked_lm_prob, zh_tokenizer=zh_tokenizer)
    datamodule = UniversalDataModule(tokenizer=tokenizer, args=args,
                                     datasets={"train": dataset})
    model, config = build_model("bart", args.model_path,
                                device=trainer.device)
    module = BartPretrainModule(args, model, config)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
