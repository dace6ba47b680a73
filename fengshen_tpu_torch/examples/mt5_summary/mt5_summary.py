"""Randeng-mT5 summarization fine-tune (LCSTS): the port of
``fengshen_tpu/examples/mt5_summary/mt5_summary.py``.

mT5 fine-tuned over ``{text, summary}`` records with the shared
``Seq2SeqCollator`` and ``Seq2SeqModule`` of ``examples/summary``
(``model_type`` ``t5`` covers mT5 checkpoints); a fit only, as in the
reference. The tokenizer is the caller's, or ``models/auto.AutoTokenizer``
of ``--model_path``.

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.mt5_summary.mt5_summary \\
        --model_path <mt5-dir> --train_file train.json \\
        --max_src_length 512 --max_tgt_length 128
"""

from __future__ import annotations

import argparse


def main(argv=None, tokenizer=None):
    """Fit; returns the Trainer."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
        Seq2SeqCollator, Seq2SeqModule, build_model)
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import Trainer, add_trainer_args
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    parser = argparse.ArgumentParser()
    parser = add_module_args(parser)
    parser = add_trainer_args(parser)
    parser = UniversalDataModule.add_data_specific_args(parser)
    parser = UniversalCheckpoint.add_argparse_args(parser)
    group = parser.add_argument_group("mt5 summary")
    group.add_argument("--max_src_length", default=512, type=int)
    group.add_argument("--max_tgt_length", default=128, type=int)
    args = parser.parse_args(argv)

    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    model, config = build_model("t5", args.model_path, device=trainer.device)
    collator = Seq2SeqCollator(
        tokenizer, max_src_length=args.max_src_length,
        max_tgt_length=args.max_tgt_length,
        decoder_start_token_id=getattr(config, "decoder_start_token_id", 0))
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    module = Seq2SeqModule(args, model, config)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
