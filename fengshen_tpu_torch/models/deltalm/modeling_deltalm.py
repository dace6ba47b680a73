"""DeltaLM in PyTorch: the port of
``fengshen_tpu/models/deltalm/modeling_deltalm.py``
(Randeng-Deltalm-362M-Zh-En, driven by ``examples/translate``).

Pre-LN layers over BART's attention (``models/bart``), with no dropout
anywhere, as in the reference. An encoder layer (:116) is ``h +
attn(ln(h))`` then ``h + fc2(act(fc1(ln(h))))``; a decoder layer (:133)
is interleaved: self-attention, a first FFN (``fc1``/``fc2`` under
``ffn1_layer_norm``), cross-attention, then a second FFN
(``fc3``/``fc4`` under ``ffn2_layer_norm``). Both FFNs of both stacks
are ``decoder_ffn_dim`` wide, as in the reference. Embeddings (:201):
``shared`` (times ``sqrt(d_model)`` with ``scale_embedding``) plus one
learned position table shared by both stacks at ``position + 2`` (the
decoder's from ``position_offset``), then each stack's
``*_emb_layer_norm``; each stack ends in a LayerNorm, and the head is
``shared`` transposed, with no bias.

Decode runs over :class:`..seq2seq_cache.Seq2SeqCache` as BART's does,
so ``utils/generate.seq2seq_generate`` and ``seq2seq_beam_search``
decode it. Parameter names are the reference's flax paths at the root
(``shared``, ``embed_positions``, ``encoder_layer_{i}.fc1``,
``decoder_layer_{i}.ffn2_layer_norm`` ...); ``convert.py`` maps HF
checkpoints and the JAX package's trees onto them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
from torch import nn

from fengshen_tpu_torch.models.bart.modeling_bart import BartAttention
from fengshen_tpu_torch.models.layers import (Embed, dense, init_weights,
                                              linear, place, torch_dtype)
from fengshen_tpu_torch.models.seq2seq_cache import Seq2SeqCache
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm

_POS_OFFSET = 2


@dataclasses.dataclass
class DeltaLMConfig:
    vocab_size: int = 250001
    d_model: int = 768
    encoder_layers: int = 12
    decoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    activation_function: str = "gelu"
    dropout: float = 0.1
    max_position_embeddings: int = 512
    decode_cache_length: int = 512
    init_std: float = 0.02
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
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
    def from_pretrained(cls, path: str) -> "DeltaLMConfig":
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
                      {"model_type": "deltalm"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "DeltaLMConfig":
        base = dict(vocab_size=128, d_model=32, encoder_layers=2,
                    decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64,
                    decoder_ffn_dim=64, max_position_embeddings=64)
        base.update(overrides)
        return cls(**base)


def _ffn(layer: nn.Module, hidden: torch.Tensor, fc_in: str,
         fc_out: str) -> torch.Tensor:
    """``fc_out(act(fc_in(hidden)))`` of ``layer`` (:106)."""
    cfg = layer.config
    dt = torch_dtype(cfg.dtype)
    h = get_activation(cfg.activation_function)(
        dense(getattr(layer, fc_in), hidden, dt))
    return dense(getattr(layer, fc_out), h, dt)


class DeltaLMEncoderLayer(nn.Module):
    def __init__(self, config: DeltaLMConfig):
        super().__init__()
        self.config = config
        d, p, ffn = config.d_model, config.param_dtype, config.decoder_ffn_dim
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = BartAttention(config, config.encoder_attention_heads)
        self.final_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, ffn, p)
        self.fc2 = linear(ffn, d, p)

    def forward(self, hidden, attention_mask=None):
        hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden),
                                         attention_mask=attention_mask)
        return hidden + _ffn(self, self.final_layer_norm(hidden), "fc1",
                             "fc2")


class DeltaLMDecoderLayer(nn.Module):
    """Interleaved: self-attention, FFN, cross-attention, FFN (:133)."""

    def __init__(self, config: DeltaLMConfig, layer_idx: int):
        super().__init__()
        self.config = config
        d, p, ffn = config.d_model, config.param_dtype, config.decoder_ffn_dim
        heads = config.decoder_attention_heads
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = BartAttention(config, heads, causal=True,
                                       layer_idx=layer_idx)
        self.ffn1_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, ffn, p)
        self.fc2 = linear(ffn, d, p)
        self.encoder_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = BartAttention(config, heads, layer_idx=layer_idx)
        self.ffn2_layer_norm = LayerNorm(d)
        self.fc3 = linear(d, ffn, p)
        self.fc4 = linear(ffn, d, p)

    def forward(self, hidden, encoder_hidden, attention_mask=None,
                encoder_attention_mask=None, cache=None,
                cross_from_cache=False):
        hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden),
                                         attention_mask=attention_mask,
                                         cache=cache)
        hidden = hidden + _ffn(self, self.ffn1_layer_norm(hidden), "fc1",
                               "fc2")
        hidden = hidden + self.encoder_attn(
            self.encoder_attn_layer_norm(hidden), kv=encoder_hidden,
            attention_mask=encoder_attention_mask, cache=cache,
            cross_from_cache=cross_from_cache)
        return hidden + _ffn(self, self.ffn2_layer_norm(hidden), "fc3",
                             "fc4")


class DeltaLMForConditionalGeneration(nn.Module):
    """The whole model and its tied head (:164). ``device=None`` means
    ``cuda`` and raises without a card; the weights are drawn there from
    ``generator`` (``init=False`` leaves them unwritten)."""

    def __init__(self, config: DeltaLMConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        with torch.device("meta"):
            self.shared = VocabParallelEmbed(config.vocab_size, d,
                                             param_dtype=torch_dtype(p))
            self.embed_positions = Embed(
                config.max_position_embeddings + _POS_OFFSET, d, p)
            self.encoder_emb_layer_norm = LayerNorm(d)
            for i in range(config.encoder_layers):
                setattr(self, f"encoder_layer_{i}",
                        DeltaLMEncoderLayer(config))
            self.encoder_layer_norm = LayerNorm(d)
            self.decoder_emb_layer_norm = LayerNorm(d)
            for i in range(config.decoder_layers):
                setattr(self, f"decoder_layer_{i}",
                        DeltaLMDecoderLayer(config, i))
            self.decoder_layer_norm = LayerNorm(d)
        place(self, device, generator, init, config.init_std)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.config.init_std)

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _embed(self, ids, position_offset: int = 0):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        scale = (cfg.d_model ** 0.5) if cfg.scale_embedding else 1.0
        pos = position_offset + torch.arange(ids.shape[1],
                                             device=ids.device) + _POS_OFFSET
        return self.shared(ids, dt) * scale + self.embed_positions(pos,
                                                                   dt)[None]

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        del deterministic, dropout_rng      # DeltaLM has no dropout
        enc = self.encoder_emb_layer_norm(self._embed(input_ids))
        for i in range(self.config.encoder_layers):
            enc = getattr(self, f"encoder_layer_{i}")(enc, attention_mask)
        return self.encoder_layer_norm(enc)

    def _decode(self, decoder_input_ids, encoder_hidden,
                decoder_attention_mask, encoder_attention_mask, cache=None,
                cross_from_cache=False, position_offset=0):
        dec = self.decoder_emb_layer_norm(
            self._embed(decoder_input_ids, position_offset))
        for i in range(self.config.decoder_layers):
            dec = getattr(self, f"decoder_layer_{i}")(
                dec, encoder_hidden, decoder_attention_mask,
                encoder_attention_mask, cache, cross_from_cache)
        if cache is not None:
            cache.advance(decoder_input_ids.shape[1])
        dec = self.decoder_layer_norm(dec)
        return dec @ self.shared.weight.to(dec.dtype).T

    def decode_logits(self, decoder_input_ids, encoder_hidden,
                      attention_mask=None, deterministic: bool = True,
                      cache: Optional[Seq2SeqCache] = None,
                      cross_from_cache: bool = False,
                      position_offset: int = 0, dropout_rng=None):
        """The decoder and the head (:213); with ``cache`` the decode
        step of ``utils/generate.py`` at ``position_offset``."""
        del deterministic, dropout_rng
        return self._decode(decoder_input_ids, encoder_hidden, None,
                            attention_mask, cache, cross_from_cache,
                            position_offset)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``[B, T, V]`` logits in the compute dtype (:221)."""
        enc = self.encode(input_ids, attention_mask)
        return self._decode(decoder_input_ids, enc, decoder_attention_mask,
                            attention_mask)

    def new_cache(self, rows: int, length: int) -> Seq2SeqCache:
        cfg = self.config
        return Seq2SeqCache.zeros(
            cfg.decoder_layers, rows, length, cfg.decoder_attention_heads,
            cfg.d_model // cfg.decoder_attention_heads, self.device,
            torch_dtype(cfg.dtype))
