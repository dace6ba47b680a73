"""Randeng-T5 QA fine-tune on CMRC-style records: the port of
``fengshen_tpu/examples/qa_t5/finetune_t5_cmrc.py`` (driven by
``finetune_t5_cmrc.sh``, ``run_finetune.sh`` and ``run_predict.sh``).

A ``{question, context, answer}`` record becomes the source
``question:{q}knowledge:{context}`` (the context cut to
``--max_knowledge_length`` characters) and the target
``<extra_id_0>{answer}`` (:class:`T5QACollator`), trained with seq2seq
CE (:class:`T5QAModule`); ``--do_eval_only`` restores the checkpoint,
decodes the test split (else the validation split) with
``--num_beams`` beams and at most ``--max_target_length`` tokens, and
writes one decoded line a row to ``--prediction_res_path``.

Run (on the card; ``--device cpu`` for the CPU), as the CMRC shell:
    python -m fengshen_tpu_torch.examples.qa_t5.finetune_t5_cmrc \\
        --model_path <randeng-t5-784M-qa> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 32 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 \\
        --max_seq_length 512 --max_target_length 64
"""

from __future__ import annotations

from dataclasses import dataclass

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqCollator, Seq2SeqModule, common_parser)


@dataclass
class T5QACollator(Seq2SeqCollator):
    """question / context / answer -> prompt and target (:29);
    batching is :class:`Seq2SeqCollator`'s."""

    max_knowledge_length: int = 425

    def source_text(self, sample: dict) -> str:
        return ("question:" + sample["question"] +
                "knowledge:" + sample["context"][: self.max_knowledge_length])

    def target_text(self, sample: dict) -> str:
        answer = sample["answer"][0] if isinstance(sample["answer"], list) \
            else sample["answer"]
        return "<extra_id_0>" + answer


class T5QAModule(Seq2SeqModule):
    """Seq2seq QA loss; beam decode of ``--max_target_length`` tokens
    (:47)."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("T5 QA")
        parser.add_argument("--max_seq_length", type=int, default=512)
        parser.add_argument("--max_knowledge_length", type=int, default=425)
        parser.add_argument("--max_target_length", type=int, default=64)
        parser.add_argument("--num_beams", type=int, default=4)
        parser.add_argument("--length_penalty", type=float, default=1.0)
        parser.add_argument("--repetition_penalty", type=float,
                            default=1.0)
        parser.add_argument("--no_repeat_ngram_size", type=int,
                            default=0)
        parser.add_argument("--min_length", type=int, default=0)
        return parent_parser

    def predict_step(self, batch: dict):
        from fengshen_tpu_torch.utils.generate import seq2seq_predict_step
        return seq2seq_predict_step(
            self.model, self.config, self.args, batch,
            max_new_tokens=self.args.max_target_length)

    def sequence_lengths(self) -> tuple:
        return int(self.args.max_seq_length), \
            int(self.args.max_target_length)


def parse_args(argv=None):
    parser = T5QAModule.add_module_specific_args(common_parser())
    group = parser.add_argument_group("qa predict")
    group.add_argument("--do_eval_only", action="store_true",
                       default=False)
    group.add_argument("--pretrained_model_path", default=None, type=str,
                       help="alias of --model_path (reference flag name)")
    group.add_argument("--prediction_res_path",
                       default="./predictions.txt", type=str)
    args = parser.parse_args(argv)
    if args.pretrained_model_path:
        args.model_path = args.pretrained_model_path
    return args


def main(argv=None, tokenizer=None):
    """Fit, or with ``--do_eval_only`` restore and write the
    predictions; return the Trainer. ``tokenizer`` defaults to
    ``--model_path``'s."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import \
        build_model
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    model, config = build_model("t5", args.model_path,
                                device=trainer.device)
    module = T5QAModule(args, model, config)
    collator = T5QACollator(
        tokenizer, max_src_length=args.max_seq_length,
        max_tgt_length=args.max_target_length,
        decoder_start_token_id=config.decoder_start_token_id,
        max_knowledge_length=args.max_knowledge_length)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    if not args.do_eval_only:
        trainer.fit(module, datamodule)
        return trainer
    state = trainer.restore_for_predict(module)
    loader = datamodule.test_dataloader() or datamodule.val_dataloader()
    outputs = trainer.predict(module, loader, state=state)
    with open(args.prediction_res_path, "w", encoding="utf-8") as f:
        for out in outputs:
            for text in tokenizer.batch_decode(out.detach().cpu().numpy(),
                                               skip_special_tokens=True):
                f.write(text + "\n")
    print("predictions saved to", args.prediction_res_path)
    return trainer


if __name__ == "__main__":
    main()
