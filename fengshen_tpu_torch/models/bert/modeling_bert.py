"""Vanilla post-LN BERT in PyTorch: the port of
``fengshen_tpu/models/bert/modeling_bert.py``.

:class:`BertLayer` is the post-LN layer (``ln(h + attention(h))``, then
``ln(h + ffn(h))``); ``pre_ln=True`` flips it to the pre-LN order with
the same parameter names, as the reference's does. :class:`BertModel`
adds word + position + token-type embeddings, an embedding LayerNorm and
dropout, the layers and the tanh pooler over ``[CLS]``;
:class:`BertForMaskedLM` the transform and the decoder tied to the word
embeddings. Dtypes, dropout and names follow ``models/layers.py`` and
``models/megatron_bert`` (``layer_{i}``, the reference's flax paths).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
from torch import nn

from fengshen_tpu_torch.models.layers import (Embed, attention_mask_bool,
                                              dense, linear, place,
                                              torch_dtype)
from fengshen_tpu_torch.models.megatron_bert.modeling_megatron_bert import (
    encoder_seeds, self_attention)
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.dropout import dropout
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass
class BertConfig:
    """The port's own copy of the reference's ``BertConfig`` (same
    fields and defaults)."""

    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    num_labels: int = 2
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_pretrained(cls, path: str) -> "BertConfig":
        cfg_file = os.path.join(path, "config.json") if os.path.isdir(path) \
            else path
        with open(cfg_file) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self) |
                      {"model_type": "bert"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "BertConfig":
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64)
        base.update(overrides)
        return cls(**base)


class BertLayer(nn.Module):
    """Post-LN layer; ``pre_ln=True`` is the pre-LN order with identical
    parameter names."""

    def __init__(self, config: BertConfig, pre_ln: bool = False):
        super().__init__()
        self.config = config
        self.pre_ln = pre_ln
        h, p = config.hidden_size, config.param_dtype
        self.attention_ln = LayerNorm(h, config.layer_norm_eps)
        self.output_ln = LayerNorm(h, config.layer_norm_eps)
        self.query = linear(h, h, p)
        self.key = linear(h, h, p)
        self.value = linear(h, h, p)
        self.attention_output_dense = linear(h, h, p)
        self.intermediate_dense = linear(h, config.intermediate_size, p)
        self.output_dense = linear(config.intermediate_size, h, p)

    def forward(self, hidden, mask=None, seeds=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_probs, s_attn, s_ffn = seeds or (None, None, None)
        x = self.attention_ln(hidden) if self.pre_ln else hidden
        out = self_attention(self, x, mask, s_probs, cfg)
        out = dense(self.attention_output_dense, out, dt)
        out = dropout(out, cfg.hidden_dropout_prob, s_attn)
        hidden = hidden + out if self.pre_ln else \
            self.attention_ln(hidden + out)
        h = self.output_ln(hidden) if self.pre_ln else hidden
        h = dense(self.intermediate_dense, h, dt)
        h = dense(self.output_dense, get_activation(cfg.hidden_act)(h), dt)
        h = dropout(h, cfg.hidden_dropout_prob, s_ffn)
        return hidden + h if self.pre_ln else self.output_ln(hidden + h)


class BertModel(nn.Module):
    """The encoder (:136). ``device=None`` means ``cuda`` and raises
    without a card; the weights are drawn there from ``generator``."""

    def __init__(self, config: BertConfig, add_pooling_layer: bool = True,
                 device=None, generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        with torch.device("meta"):
            self.word_embeddings = VocabParallelEmbed(
                config.vocab_size, h, param_dtype=torch_dtype(p))
            self.position_embeddings = Embed(
                config.max_position_embeddings, h, p)
            self.token_type_embeddings = Embed(config.type_vocab_size, h, p)
            self.embeddings_ln = LayerNorm(h, config.layer_norm_eps)
            for i in range(config.num_hidden_layers):
                setattr(self, f"layer_{i}", BertLayer(config))
            self.pooler = linear(h, h, p) if add_pooling_layer else None
        place(self, device, generator, init, config.initializer_range)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``(hidden [B, S, H], pooled [B, H] or None)``."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        seq = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(seq, device=input_ids.device)[None]
        embed_seed, layer_seeds = encoder_seeds(
            cfg, cfg.num_hidden_layers, deterministic, dropout_rng)
        hidden = self.word_embeddings(input_ids, dt) \
            + self.position_embeddings(position_ids, dt) \
            + self.token_type_embeddings(token_type_ids, dt)
        hidden = dropout(self.embeddings_ln(hidden),
                         cfg.hidden_dropout_prob, embed_seed)
        mask = attention_mask_bool(attention_mask)
        for i, seeds in enumerate(layer_seeds):
            hidden = getattr(self, f"layer_{i}")(hidden, mask, seeds)
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(dense(self.pooler, hidden[:, 0], dt))
        return hidden, pooled


class BertForMaskedLM(nn.Module):
    """``bert`` (no pooler), then ``transform_dense``, the activation,
    ``transform_ln``, the decoder tied to the word embeddings and
    ``bias``: fp32 logits ``[B, S, V]``."""

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        with torch.device("meta"):
            self.bert = BertModel(config, add_pooling_layer=False,
                                  device="meta", init=False)
            self.transform_dense = linear(h, h, p)
            self.transform_ln = LayerNorm(h, config.layer_norm_eps)
            self.bias = nn.Parameter(torch.empty(config.vocab_size,
                                                 dtype=torch_dtype(p)))
        place(self, device, generator, init, config.initializer_range)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None,
                return_hidden: bool = False):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        hidden, _ = self.bert(input_ids, attention_mask, token_type_ids,
                              position_ids, deterministic, dropout_rng)
        h = dense(self.transform_dense, hidden, dt)
        h = self.transform_ln(get_activation(cfg.hidden_act)(h))
        logits = h @ self.bert.word_embeddings.weight.to(h.dtype).T \
            + self.bias
        return (logits, hidden) if return_hidden else logits
