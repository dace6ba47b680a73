"""Task heads over the BERT-like encoders: the port of
``fengshen_tpu/models/heads.py`` (``make_task_heads``, :33).

One factory builds ``ForSequenceClassification``,
``ForTokenClassification``, ``ForQuestionAnswering`` and
``ForMultipleChoice`` for any encoder class ``encoder_cls(config,
add_pooling_layer=..., device=..., init=...)`` whose forward maps
``input_ids`` (and keyword inputs such as ``attention_mask`` and
``token_type_ids``) to ``(hidden, pooled)``, or, with
``has_pooler=False`` (DeBERTa-v2), an encoder ``encoder_cls(config,
device=..., init=...)`` that maps them to ``hidden`` alone: then the
sequence-classification and multiple-choice heads pool ``[CLS]``
through a ``pooler`` projection and tanh of their own, as the
reference's factory does. The encoder sits under ``encoder_name``; the
heads' projections follow flax's dtype policy (``models/layers.py``) and
draw their dropout seed after the encoder's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from fengshen_tpu_torch.models.layers import dense, linear, place, \
    torch_dtype
from fengshen_tpu_torch.ops.dropout import dropout, site_seeds


def _dt(cfg) -> torch.dtype:
    return torch_dtype(getattr(cfg, "dtype", "float32"))


def _param_dtype(cfg) -> str:
    return getattr(cfg, "param_dtype", "float32")


def make_task_heads(encoder_cls: Callable, *, has_pooler: bool = True,
                    encoder_name: str = "encoder") -> tuple:
    """``(ForSequenceClassification, ForTokenClassification,
    ForQuestionAnswering, ForMultipleChoice)`` over ``encoder_cls``."""

    class _Head(nn.Module):
        pooled_needed = True

        def __init__(self, config: Any, device=None,
                     generator: Optional[torch.Generator] = None,
                     init: bool = True, **head_args):
            super().__init__()
            self.config = config
            pooling = {"add_pooling_layer": self.pooled_needed} \
                if has_pooler else {}
            with torch.device("meta"):
                setattr(self, encoder_name, encoder_cls(
                    config, device="meta", init=False, **pooling))
                if self.pooled_needed and not has_pooler:
                    self.pooler = linear(config.hidden_size,
                                         config.hidden_size,
                                         _param_dtype(config))
                self.build(config, **head_args)
            place(self, device, generator, init,
                  getattr(config, "initializer_range", 0.02))

        def build(self, config) -> None:
            raise NotImplementedError

        def encode(self, input_ids, deterministic, dropout_rng, kwargs):
            """``(hidden, pooled)``; ``pooled`` is None from an encoder
            without a pooler when the head pools nothing."""
            out = getattr(self, encoder_name)(
                input_ids, deterministic=deterministic,
                dropout_rng=dropout_rng, **kwargs)
            if has_pooler:
                return out
            pooled = torch.tanh(dense(self.pooler, out[:, 0],
                                      _dt(self.config))) \
                if self.pooled_needed else None
            return out, pooled

        def drop(self, x, deterministic, dropout_rng):
            rate = getattr(self.config, "hidden_dropout_prob", 0.1)
            if deterministic or not rate:
                return x
            return dropout(x, rate, site_seeds(dropout_rng, 1)[0])

    class ForSequenceClassification(_Head):
        """Pooled ``[CLS]``, dropout, ``classifier`` to ``num_labels``
        (the factory's own default of 2, as in the reference)."""

        def build(self, config, num_labels: int = 2) -> None:
            self.num_labels = num_labels
            self.classifier = linear(config.hidden_size, num_labels,
                                     _param_dtype(config))

        def forward(self, input_ids, deterministic=True, dropout_rng=None,
                    **kwargs):
            _, pooled = self.encode(input_ids, deterministic, dropout_rng,
                                    kwargs)
            pooled = self.drop(pooled, deterministic, dropout_rng)
            return dense(self.classifier, pooled, _dt(self.config))

    class ForTokenClassification(_Head):
        pooled_needed = False

        def build(self, config, num_labels: int = 2) -> None:
            self.num_labels = num_labels
            self.classifier = linear(config.hidden_size, num_labels,
                                     _param_dtype(config))

        def forward(self, input_ids, deterministic=True, dropout_rng=None,
                    **kwargs):
            hidden, _ = self.encode(input_ids, deterministic, dropout_rng,
                                    kwargs)
            hidden = self.drop(hidden, deterministic, dropout_rng)
            return dense(self.classifier, hidden, _dt(self.config))

    class ForQuestionAnswering(_Head):
        """``(start_logits [B, S], end_logits [B, S])``."""

        pooled_needed = False

        def build(self, config) -> None:
            self.qa_outputs = linear(config.hidden_size, 2,
                                     _param_dtype(config))

        def forward(self, input_ids, deterministic=True, dropout_rng=None,
                    **kwargs):
            hidden, _ = self.encode(input_ids, deterministic, dropout_rng,
                                    kwargs)
            logits = dense(self.qa_outputs, hidden, _dt(self.config))
            return logits[..., 0], logits[..., 1]

    class ForMultipleChoice(_Head):
        """``input_ids [B, C, S]`` (per-choice keyword inputs likewise)
        -> choice logits ``[B, C]``."""

        def build(self, config) -> None:
            self.classifier = linear(config.hidden_size, 1,
                                     _param_dtype(config))

        def forward(self, input_ids, deterministic=True, dropout_rng=None,
                    **kwargs):
            batch, n_choices, seq = input_ids.shape
            flat = {k: v.reshape((batch * n_choices,) + tuple(v.shape[2:]))
                    if torch.is_tensor(v) and v.dim() >= 3 and
                    tuple(v.shape[:2]) == (batch, n_choices) else v
                    for k, v in kwargs.items()}
            _, pooled = self.encode(
                input_ids.reshape(batch * n_choices, seq), deterministic,
                dropout_rng, flat)
            pooled = self.drop(pooled, deterministic, dropout_rng)
            score = dense(self.classifier, pooled, _dt(self.config))
            return score.reshape(batch, n_choices)

    return (ForSequenceClassification, ForTokenClassification,
            ForQuestionAnswering, ForMultipleChoice)
