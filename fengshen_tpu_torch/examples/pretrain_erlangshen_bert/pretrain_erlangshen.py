"""Erlangshen-MegatronBert pretraining, MLM + sentence order: the port of
``fengshen_tpu/examples/pretrain_erlangshen_bert/pretrain_erlangshen.py``
(driven by ``pretrain_erlangshen_base.sh``).

:class:`ErLangShenCollator` (:36-100) splits each text into sentences,
pairs them for sentence-order prediction (swapped with probability
0.5), truncates the pair to ``--max_seq_length - 3``, assembles ``[CLS]
A [SEP] B [SEP]`` with token types, masks whole words (jieba words of
the wordpieces) BERT style and pads with -100 labels; every draw comes
from one ``RandomState(seed)`` in the JAX package's order, so the
batches are its batches bitwise. :class:`ErLangShenBert` (:103-154)
takes MLM CE plus SOP CE on ``MegatronBertForPreTraining``, logs
``mlm_loss``, ``sop_loss``, ``mlm_acc`` and ``n_tokens``, and counts
``flops_per_token`` as the JAX module does.

``main(tokenizer=..., zh_tokenizer=...)``: the tokenizer defaults to
``--model_path``'s (``models/auto.AutoTokenizer``); the word segmenter
to ``jieba.lcut``, which raises ``ImportError`` where ``jieba`` is not
installed. ``zh_tokenizer=False`` groups wordpieces by their ``##``
prefix (what the JAX collator falls back to quietly without ``jieba``),
a callable segments the text itself. The model loads ``--model_path``'s
HF checkpoint where the directory holds one.

Run (on the card; ``--device cpu`` for the CPU), as the shell on one
device:
    python -m fengshen_tpu_torch.examples.pretrain_erlangshen_bert.\\
pretrain_erlangshen \\
        --model_path <erlangshen-dir> --train_file corpus.jsonl \\
        --max_seq_length 512 --masked_lm_prob 0.15 --train_batchsize 8 \\
        --fsdp_parallel_size 1 --learning_rate 1e-4 --warmup_ratio 0.01 \\
        --scheduler_type polynomial --max_steps 100000 \\
        --every_n_train_steps 1000 --save_ckpt_path runs/ckpt \\
        --load_ckpt_path runs/ckpt --default_root_dir runs
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.data.data_utils.rng_state import SeededCollator
from fengshen_tpu_torch.data.data_utils import (ChineseSentenceSplitter,
                                                create_masked_lm_predictions,
                                                create_tokens_and_tokentypes,
                                                get_a_and_b_segments,
                                                truncate_segments)
from fengshen_tpu_torch.examples.pretrain_bert.pretrain_bert import (
    MaskedLMModule, fit, mlm_accuracy, pretrain_parser)
from fengshen_tpu_torch.parallel.cross_entropy import stable_cross_entropy


@dataclass
class ErLangShenCollator(SeededCollator):
    """Text -> MLM + SOP batch (:36): ``input_ids``, ``attention_mask``,
    ``token_type_ids``, ``labels`` ``[B, max_seq_length]`` and
    ``next_sentence_label [B]``. ``zh_tokenizer``: None is
    ``jieba.lcut`` (raising without ``jieba``), False the wordpiece
    grouping."""

    tokenizer: Any
    max_seq_length: int = 512
    masked_lm_prob: float = 0.15
    content_key: str = "text"
    seed: int = 42
    zh_tokenizer: Optional[Any] = None

    def __post_init__(self):
        from fengshen_tpu_torch.data.data_utils.mask_utils import jieba_lcut
        self.splitter = ChineseSentenceSplitter()
        self.np_rng = np.random.RandomState(self.seed)
        if self.zh_tokenizer is None:
            self.zh_tokenizer = jieba_lcut("ErLangShenCollator")
        self.zh_tokenizer = self.zh_tokenizer or None
        vocab = self.tokenizer.get_vocab()
        self.vocab_id_list = list(vocab.values())
        self.vocab_id_to_token = {v: k for k, v in vocab.items()}
        self.cls_id = self.tokenizer.cls_token_id
        self.sep_id = self.tokenizer.sep_token_id
        self.mask_id = self.tokenizer.mask_token_id
        self.pad_id = self.tokenizer.pad_token_id or 0

    def _encode_sentences(self, text: str) -> list:
        return [self.tokenizer.encode(s, add_special_tokens=False)
                for s in self.splitter.tokenize(text) if s]

    def __call__(self, samples: list) -> dict:
        batch = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
                 "labels": [], "next_sentence_label": []}
        max_len = self.max_seq_length
        for sample in samples:
            sents = [s for s in self._encode_sentences(
                sample[self.content_key]) if s]
            if len(sents) < 2:
                # one sentence: its halves make the pair
                flat = sents[0] if sents else [self.mask_id]
                half = max(len(flat) // 2, 1)
                sents = [flat[:half], flat[half:] or [flat[-1]]]
            a, b, is_random = get_a_and_b_segments(sents, self.np_rng)
            truncate_segments(a, b, len(a), len(b), max_len - 3, self.np_rng)
            tokens, tokentypes = create_tokens_and_tokentypes(
                a, b, self.cls_id, self.sep_id)
            masked_tokens, positions, labels = create_masked_lm_predictions(
                tokens, self.vocab_id_list, self.vocab_id_to_token,
                self.masked_lm_prob, self.cls_id, self.sep_id, self.mask_id,
                max_predictions_per_seq=int(
                    self.masked_lm_prob * max_len) + 1,
                np_rng=self.np_rng, zh_tokenizer=self.zh_tokenizer)
            mlm_labels = [-100] * len(tokens)
            for pos, label in zip(positions, labels):
                mlm_labels[pos] = label
            pad = max_len - len(masked_tokens)
            batch["input_ids"].append(masked_tokens + [self.pad_id] * pad)
            batch["attention_mask"].append([1] * len(masked_tokens) +
                                           [0] * pad)
            batch["token_type_ids"].append(tokentypes + [0] * pad)
            batch["labels"].append(mlm_labels + [-100] * pad)
            batch["next_sentence_label"].append(int(is_random))
        return {k: np.asarray(v) for k, v in batch.items()}


class ErLangShenBert(MaskedLMModule):
    """MLM CE + SOP CE on ``MegatronBertForPreTraining`` (:103)."""

    convert = "fengshen_tpu_torch.models.megatron_bert.convert"

    def training_loss(self, batch: dict) -> tuple:
        mlm_logits, sop_logits = self.forward(
            batch, token_type_ids=batch["token_type_ids"])
        labels = batch["labels"]
        mlm_loss, n_tokens = stable_cross_entropy(mlm_logits, labels)
        sop_loss, _ = stable_cross_entropy(
            sop_logits[:, None, :], batch["next_sentence_label"][:, None])
        return mlm_loss + sop_loss, {
            "mlm_loss": mlm_loss.detach(), "sop_loss": sop_loss.detach(),
            "mlm_acc": mlm_accuracy(mlm_logits, labels),
            "n_tokens": n_tokens}

    def flops_per_token(self) -> float:
        """The JAX module's count (:147): 6 x (layers x (4 h^2 + 2 h i)
        + h V); attention's sequence-length term is left out."""
        cfg = self.config
        per_layer = 4 * cfg.hidden_size ** 2 + \
            2 * cfg.hidden_size * cfg.intermediate_size
        return 6.0 * (cfg.num_hidden_layers * per_layer +
                      cfg.hidden_size * cfg.vocab_size)


def main(argv=None, tokenizer=None, zh_tokenizer=None):
    """Fit over ``--train_file``; return the Trainer."""
    from fengshen_tpu_torch.models.megatron_bert import (
        MegatronBertConfig, MegatronBertForPreTraining)

    args = pretrain_parser(ErLangShenBert).parse_args(argv)
    return fit(args, ErLangShenBert, MegatronBertForPreTraining,
               MegatronBertConfig, tokenizer, lambda tok: ErLangShenCollator(
                   tok, max_seq_length=args.max_seq_length,
                   masked_lm_prob=args.masked_lm_prob,
                   zh_tokenizer=zh_tokenizer))


if __name__ == "__main__":
    main()
