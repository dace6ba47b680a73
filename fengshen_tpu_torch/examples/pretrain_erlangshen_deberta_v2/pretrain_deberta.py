"""Erlangshen-DeBERTa-v2 whole-word-masking pretraining: the port of
``fengshen_tpu/examples/pretrain_erlangshen_deberta_v2/pretrain_deberta.py``
(driven by ``pretrain_deberta_base.sh``).

:class:`DeBERTaV2Collator` (:30-76) encodes each text, cuts it to
``--max_seq_length - 2`` tokens between ``[CLS]`` and ``[SEP]``, masks
whole words BERT style (``create_masked_lm_predictions``) and pads with
-100 labels; its draws come from one ``RandomState(seed)`` in the JAX
package's order, so the batches are its batches bitwise.
:class:`DebertaPretrainModule` (:79-114) takes the MLM CE on
``DebertaV2ForMaskedLM`` and logs ``mlm_acc`` and ``n_tokens``.

``main(tokenizer=..., zh_tokenizer=...)`` as in
``pretrain_erlangshen_bert``: ``zh_tokenizer=None`` is ``jieba.lcut``
(raising without ``jieba``), ``False`` the wordpiece grouping (what the
JAX collator falls back to quietly without ``jieba``).

Run (on the card; ``--device cpu`` for the CPU), as the shell:
    python -m fengshen_tpu_torch.examples.pretrain_erlangshen_deberta_v2.\\
pretrain_deberta \\
        --model_path <deberta-dir> --train_file train.json \\
        --default_root_dir runs --save_ckpt_path ckpt \\
        --load_ckpt_path ckpt --train_batchsize 32 --max_steps 100000 \\
        --learning_rate 1e-4 --warmup_steps 1000 \\
        --every_n_train_steps 5000 --precision bf16 --max_seq_length 512
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.data.data_utils.rng_state import SeededCollator
from fengshen_tpu_torch.data.data_utils import create_masked_lm_predictions
from fengshen_tpu_torch.examples.pretrain_bert.pretrain_bert import (
    MaskedLMModule, fit, pretrain_parser)


@dataclass
class DeBERTaV2Collator(SeededCollator):
    """Text -> whole-word-masked MLM batch (:30): ``input_ids``,
    ``attention_mask`` and ``labels``, ``[B, max_seq_length]``."""

    tokenizer: Any
    max_seq_length: int = 512
    masked_lm_prob: float = 0.15
    content_key: str = "text"
    seed: int = 42
    zh_tokenizer: Optional[Any] = None

    def __post_init__(self):
        from fengshen_tpu_torch.data.data_utils.mask_utils import jieba_lcut
        self.np_rng = np.random.RandomState(self.seed)
        if self.zh_tokenizer is None:
            self.zh_tokenizer = jieba_lcut("DeBERTaV2Collator")
        self.zh_tokenizer = self.zh_tokenizer or None
        vocab = self.tokenizer.get_vocab()
        self.vocab_id_list = list(vocab.values())
        self.vocab_id_to_token = {v: k for k, v in vocab.items()}

    def __call__(self, samples: list) -> dict:
        tok = self.tokenizer
        max_len = self.max_seq_length
        batch = {"input_ids": [], "attention_mask": [], "labels": []}
        for sample in samples:
            body = tok.encode(sample[self.content_key],
                              add_special_tokens=False)[: max_len - 2]
            tokens = [tok.cls_token_id] + body + [tok.sep_token_id]
            masked_tokens, positions, labels = create_masked_lm_predictions(
                tokens, self.vocab_id_list, self.vocab_id_to_token,
                self.masked_lm_prob, tok.cls_token_id, tok.sep_token_id,
                tok.mask_token_id,
                max_predictions_per_seq=int(
                    self.masked_lm_prob * max_len) + 1,
                np_rng=self.np_rng, masking_style="bert",
                zh_tokenizer=self.zh_tokenizer)
            mlm_labels = [-100] * len(tokens)
            for pos, label in zip(positions, labels):
                mlm_labels[pos] = label
            pad_id = tok.pad_token_id or 0
            pad = max_len - len(masked_tokens)
            batch["input_ids"].append(masked_tokens + [pad_id] * pad)
            batch["attention_mask"].append([1] * len(masked_tokens) +
                                           [0] * pad)
            batch["labels"].append(mlm_labels + [-100] * pad)
        return {k: np.asarray(v) for k, v in batch.items()}


class DebertaPretrainModule(MaskedLMModule):
    """MLM CE on ``DebertaV2ForMaskedLM`` (:79)."""

    convert = "fengshen_tpu_torch.models.deberta_v2.convert"


def main(argv=None, tokenizer=None, zh_tokenizer=None):
    """Fit over ``--train_file``; return the Trainer."""
    from fengshen_tpu_torch.models.deberta_v2 import (DebertaV2Config,
                                                      DebertaV2ForMaskedLM)

    args = pretrain_parser(DebertaPretrainModule).parse_args(argv)
    return fit(args, DebertaPretrainModule, DebertaV2ForMaskedLM,
               DebertaV2Config, tokenizer, lambda tok: DeBERTaV2Collator(
                   tok, max_seq_length=args.max_seq_length,
                   masked_lm_prob=args.masked_lm_prob,
                   zh_tokenizer=zh_tokenizer))


if __name__ == "__main__":
    main()
