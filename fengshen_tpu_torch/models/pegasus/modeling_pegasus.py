"""Pegasus in PyTorch: the port of
``fengshen_tpu/models/pegasus/modeling_pegasus.py`` (Randeng-Pegasus
summarization).

BART's attention (``models/bart``) in pre-LN layers (:114-164): ``h +
attn(ln(h))``, in the decoder ``h + cross(ln(h), encoder)``, then ``h +
fc2(act(fc1(ln(h))))``, with no dropout anywhere, as in the reference.
Embeddings (:190-197): ``shared`` times ``sqrt(d_model)`` (with
``scale_embedding``) plus the static :func:`sinusoidal_positions` table
(:102) sliced at ``position_offset``, its start clamped as
``dynamic_slice_in_dim`` clamps it; each stack ends in a LayerNorm, and
the head is tied to ``shared`` plus the fp32 ``final_logits_bias``.
Decode runs over :class:`..seq2seq_cache.Seq2SeqCache` as BART's does.
Parameter names are the reference's flax paths (``shared``,
``encoder_layer_{i}``, ``encoder_layer_norm`` ...: the module sits at
the root, with no ``model`` prefix).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from fengshen_tpu_torch.models.bart.modeling_bart import BartAttention
from fengshen_tpu_torch.models.layers import (dense, init_weights, linear,
                                              place, torch_dtype)
from fengshen_tpu_torch.models.seq2seq_cache import Seq2SeqCache
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass
class PegasusConfig:
    vocab_size: int = 96103
    d_model: int = 1024
    encoder_layers: int = 16
    decoder_layers: int = 16
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    activation_function: str = "gelu"
    dropout: float = 0.1
    max_position_embeddings: int = 1024
    decode_cache_length: int = 512
    init_std: float = 0.02
    scale_embedding: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def hidden_size(self) -> int:
        return self.d_model

    @property
    def num_hidden_layers(self) -> int:
        return self.encoder_layers + self.decoder_layers

    @property
    def intermediate_size(self) -> int:
        return self.encoder_ffn_dim

    @classmethod
    def from_pretrained(cls, path: str) -> "PegasusConfig":
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
                      {"model_type": "pegasus"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "PegasusConfig":
        base = dict(vocab_size=128, d_model=32, encoder_layers=2,
                    decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64,
                    decoder_ffn_dim=64, max_position_embeddings=64)
        base.update(overrides)
        return cls(**base)


def sinusoidal_positions(n_pos: int, dim: int) -> torch.Tensor:
    """HF Pegasus's sinusoidal table (:102), fp32 ``[n_pos, dim]``: sin
    in the first half, cos in the second, computed in float64 as
    numpy does."""
    position_enc = np.array(
        [[pos / np.power(10000, 2 * (j // 2) / dim) for j in range(dim)]
         for pos in range(n_pos)])
    table = np.zeros((n_pos, dim), np.float32)
    sentinel = dim // 2 + dim % 2
    table[:, :sentinel] = np.sin(position_enc[:, 0::2])
    table[:, sentinel:] = np.cos(position_enc[:, 1::2])
    return torch.from_numpy(table)


class _PegasusEncoderLayer(nn.Module):
    def __init__(self, config: PegasusConfig):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = BartAttention(config, config.encoder_attention_heads)
        self.final_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, config.encoder_ffn_dim, p)
        self.fc2 = linear(config.encoder_ffn_dim, d, p)

    def forward(self, hidden, attention_mask=None):
        dt = torch_dtype(self.config.dtype)
        hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden),
                                         attention_mask=attention_mask)
        h = get_activation(self.config.activation_function)(
            dense(self.fc1, self.final_layer_norm(hidden), dt))
        return hidden + dense(self.fc2, h, dt)


class _PegasusDecoderLayer(nn.Module):
    def __init__(self, config: PegasusConfig, layer_idx: int):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        heads = config.decoder_attention_heads
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = BartAttention(config, heads, causal=True,
                                       layer_idx=layer_idx)
        self.encoder_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = BartAttention(config, heads, layer_idx=layer_idx)
        self.final_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, config.decoder_ffn_dim, p)
        self.fc2 = linear(config.decoder_ffn_dim, d, p)

    def forward(self, hidden, encoder_hidden, attention_mask=None,
                encoder_attention_mask=None, cache=None,
                cross_from_cache=False):
        dt = torch_dtype(self.config.dtype)
        hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden),
                                         attention_mask=attention_mask,
                                         cache=cache)
        hidden = hidden + self.encoder_attn(
            self.encoder_attn_layer_norm(hidden), kv=encoder_hidden,
            attention_mask=encoder_attention_mask, cache=cache,
            cross_from_cache=cross_from_cache)
        h = get_activation(self.config.activation_function)(
            dense(self.fc1, self.final_layer_norm(hidden), dt))
        return hidden + dense(self.fc2, h, dt)


class PegasusForConditionalGeneration(nn.Module):
    """The whole model and its tied head (:167). ``device=None`` means
    ``cuda`` and raises without a card; the weights are drawn there from
    ``generator`` (``init=False`` leaves them unwritten)."""

    def __init__(self, config: PegasusConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        d = config.d_model
        with torch.device("meta"):
            self.shared = VocabParallelEmbed(
                config.vocab_size, d,
                param_dtype=torch_dtype(config.param_dtype))
            for i in range(config.encoder_layers):
                setattr(self, f"encoder_layer_{i}",
                        _PegasusEncoderLayer(config))
            for i in range(config.decoder_layers):
                setattr(self, f"decoder_layer_{i}",
                        _PegasusDecoderLayer(config, i))
            self.encoder_layer_norm = LayerNorm(d)
            self.decoder_layer_norm = LayerNorm(d)
            self.final_logits_bias = nn.Parameter(
                torch.zeros(config.vocab_size, dtype=torch.float32))
        place(self, device, generator, init, config.init_std)
        self._positions: Optional[torch.Tensor] = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.config.init_std)

    def _embed(self, ids, position_offset: int = 0):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        seq, n_pos = ids.shape[1], cfg.max_position_embeddings
        if seq > n_pos:
            raise ValueError(f"{seq} positions > max_position_embeddings "
                             f"{n_pos}")
        if self._positions is None or self._positions.device != ids.device:
            self._positions = sinusoidal_positions(n_pos, cfg.d_model).to(
                ids.device)
        start = min(max(int(position_offset), 0), n_pos - seq)
        pos = self._positions[start:start + seq]
        scale = (cfg.d_model ** 0.5) if cfg.scale_embedding else 1.0
        return self.shared(ids, dt) * scale + pos[None].to(dt)

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        del deterministic, dropout_rng      # Pegasus has no dropout
        enc = self._embed(input_ids)
        for i in range(self.config.encoder_layers):
            enc = getattr(self, f"encoder_layer_{i}")(enc, attention_mask)
        return self.encoder_layer_norm(enc)

    def _decode(self, decoder_input_ids, encoder_hidden,
                decoder_attention_mask, encoder_attention_mask, cache=None,
                cross_from_cache=False, position_offset=0):
        dec = self._embed(decoder_input_ids, position_offset)
        for i in range(self.config.decoder_layers):
            dec = getattr(self, f"decoder_layer_{i}")(
                dec, encoder_hidden, decoder_attention_mask,
                encoder_attention_mask, cache, cross_from_cache)
        if cache is not None:
            cache.advance(decoder_input_ids.shape[1])
        dec = self.decoder_layer_norm(dec)
        logits = dec @ self.shared.weight.to(dec.dtype).T
        return logits + self.final_logits_bias.to(logits.dtype)

    def decode_logits(self, decoder_input_ids, encoder_hidden,
                      attention_mask=None, deterministic: bool = True,
                      cache: Optional[Seq2SeqCache] = None,
                      cross_from_cache: bool = False,
                      position_offset: int = 0, dropout_rng=None):
        del deterministic, dropout_rng
        return self._decode(decoder_input_ids, encoder_hidden, None,
                            attention_mask, cache, cross_from_cache,
                            position_offset)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``[B, T, V]`` logits in the compute dtype (:228)."""
        enc = self.encode(input_ids, attention_mask)
        return self._decode(decoder_input_ids, enc, decoder_attention_mask,
                            attention_mask)

    def new_cache(self, rows: int, length: int) -> Seq2SeqCache:
        cfg = self.config
        return Seq2SeqCache.zeros(
            cfg.decoder_layers, rows, length, cfg.decoder_attention_heads,
            cfg.d_model // cfg.decoder_attention_heads, self.device,
            torch_dtype(cfg.dtype))

    @property
    def device(self) -> torch.device:
        return self.final_logits_bias.device
