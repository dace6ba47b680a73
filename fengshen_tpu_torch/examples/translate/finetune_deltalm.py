"""DeltaLM machine-translation fine-tune (zh <-> en): the port of
``fengshen_tpu/examples/translate/finetune_deltalm.py`` (driven by
``finetune_deltalm.sh``).

``{src, tgt}`` pairs (reversed by ``--reverse_src_tgt``) become seq2seq
batches (:class:`TranslationCollator`, ``--max_enc_length`` and
``--max_dec_length`` tokens); :class:`DeltaLMTranslationModule` trains
CE over ``models/deltalm`` mixed with ``--label_smooth`` of the mean
negative log-probability over the vocabulary (uniform label
smoothing).

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.translate.finetune_deltalm \\
        --model_path <randeng-deltalm-362M> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 16 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 \\
        --max_enc_length 256 --max_dec_length 256
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fengshen_tpu_torch.examples.summary.seq2seq_summary import (
    Seq2SeqCollator, Seq2SeqModule, common_parser)
from fengshen_tpu_torch.parallel.cross_entropy import (
    vocab_parallel_cross_entropy)


@dataclass
class TranslationCollator(Seq2SeqCollator):
    """``{src, tgt}`` -> seq2seq batch (:25); batching is
    :class:`Seq2SeqCollator`'s."""

    reverse_src_tgt: bool = False

    def source_text(self, sample: dict) -> str:
        return sample["tgt"] if self.reverse_src_tgt else sample["src"]

    def target_text(self, sample: dict) -> str:
        return sample["src"] if self.reverse_src_tgt else sample["tgt"]


class DeltaLMTranslationModule(Seq2SeqModule):
    """Label-smoothed seq2seq CE (:39)."""

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("deltalm translate")
        parser.add_argument("--max_enc_length", type=int, default=256)
        parser.add_argument("--max_dec_length", type=int, default=256)
        parser.add_argument("--reverse_src_tgt", action="store_true",
                            default=False)
        parser.add_argument("--label_smooth", type=float, default=0.1)
        return parent_parser

    def training_loss(self, batch: dict) -> tuple:
        """``(1 - s) CE + s x`` the mean over valid tokens of the mean
        negative log-probability over the vocabulary (:60)."""
        logits = self._logits(batch)
        labels = batch["labels"]
        loss, n_tokens = vocab_parallel_cross_entropy(logits, labels)
        smooth = getattr(self.args, "label_smooth", 0.0)
        if smooth:
            logp = torch.log_softmax(logits.float(), -1)
            valid = (labels != -100)[..., None]
            uniform = -(logp * valid).mean(-1).sum() / \
                valid.sum().clamp(min=1)
            loss = (1 - smooth) * loss + smooth * uniform
        return loss, {"n_tokens": n_tokens}

    def sequence_lengths(self) -> tuple:
        return int(self.args.max_enc_length), int(self.args.max_dec_length)


def main(argv=None, tokenizer=None):
    """Fit; return the Trainer. ``tokenizer`` defaults to
    ``--model_path``'s."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.deltalm import (
        DeltaLMConfig, DeltaLMForConditionalGeneration)
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)

    args = DeltaLMTranslationModule.add_module_specific_args(
        common_parser()).parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    config = DeltaLMConfig.from_pretrained(args.model_path)
    model = DeltaLMForConditionalGeneration(config, device=trainer.device,
                                            init=False)
    module = DeltaLMTranslationModule(args, model, config)
    collator = TranslationCollator(
        tokenizer, max_src_length=args.max_enc_length,
        max_tgt_length=args.max_dec_length,
        decoder_start_token_id=config.decoder_start_token_id,
        reverse_src_tgt=args.reverse_src_tgt)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
