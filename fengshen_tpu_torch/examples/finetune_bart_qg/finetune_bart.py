"""Randeng-BART question generation (ChineseSQuAD) fine-tune: the port
of ``fengshen_tpu/examples/finetune_bart_qg/finetune_bart.py`` (driven
by ``finetune_bart.sh``).

Answer-aware question generation: the context, its answer span masked
by ``--mask_ans_style`` (``normal``: the tokenizer's mask token;
``unmask``: kept; ``anstoken``: an ``<ans>`` marker), then the
tokenizer's separator and the answer, is the source; the question is
the target (:class:`BartQGCollator`); :class:`BartQGModule` trains
seq2seq CE over BART.

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.finetune_bart_qg.finetune_bart \\
        --model_path <randeng-bart-139M-qg> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 32 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 \\
        --mask_ans_style anstoken
"""

from __future__ import annotations

from dataclasses import dataclass

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqCollator, Seq2SeqModule, common_parser)


def _answer(sample: dict) -> str:
    answer = sample["answer"]
    return answer[0] if isinstance(answer, list) else answer


@dataclass
class BartQGCollator(Seq2SeqCollator):
    """``{context, answer, ans_span, question}`` -> seq2seq sample
    (:28); batching is :class:`Seq2SeqCollator`'s."""

    mask_ans_style: str = "anstoken"
    ans_token: str = "<ans>"

    def mask_context(self, sample: dict) -> str:
        """The context with its answer masked by the style (:40): at
        ``ans_span`` when given, else at the answer's first
        occurrence."""
        context = sample["context"]
        if self.mask_ans_style == "unmask":
            return context
        if self.mask_ans_style == "normal":
            token = self.tokenizer.mask_token or self.ans_token
        else:
            token = self.ans_token
        span = sample.get("ans_span")
        if span:
            bos, eos = span[0] if isinstance(span[0], (list, tuple)) else span
            return context[:bos] + token + context[eos:]
        return context.replace(_answer(sample), token, 1)

    def source_text(self, sample: dict) -> str:
        sep = self.tokenizer.sep_token or ""
        return self.mask_context(sample) + sep + _answer(sample)

    def target_text(self, sample: dict) -> str:
        return sample["question"]


class BartQGModule(Seq2SeqModule):
    """Seq2seq QG CE (:64)."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("BART QG")
        parser.add_argument("--max_seq_length", type=int, default=512)
        parser.add_argument("--max_target_length", type=int, default=64)
        parser.add_argument(
            "--mask_ans_style", default="anstoken", type=str,
            choices=["normal", "unmask", "anstoken"])
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

    args = BartQGModule.add_module_specific_args(
        common_parser()).parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    model, config = build_model("bart", args.model_path,
                                device=trainer.device)
    module = BartQGModule(args, model, config)
    collator = BartQGCollator(
        tokenizer, max_src_length=args.max_seq_length,
        max_tgt_length=args.max_target_length,
        decoder_start_token_id=config.decoder_start_token_id,
        mask_ans_style=args.mask_ans_style)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
