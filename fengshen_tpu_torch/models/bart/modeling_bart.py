"""BART in PyTorch: the port of ``fengshen_tpu/models/bart/modeling_bart.py``
(Randeng-BART, the lexically constrained ``BartForTextInfill``).

Post-LN layers (:203-249): ``ln(h + dropout(attn(h)))``, in the decoder
``ln(h + dropout(cross(h, encoder)))``, then ``ln(h +
dropout(fc2(act(fc1(h)))))``. :class:`BartAttention` (:114-200) projects
q, k and v with biases and runs the dense attention of
``ops/attention.py`` (scaled, fp32 scores and softmax, the mask as a
-1e9 bias; the reference passes no attention dropout); the cacheless
decoder mask is causal ANDed with the ``[B, T]`` decoder padding mask,
the encoder's and the cross-attention's the ``[B, S]`` padding mask.
Embeddings (:286-314): ``shared`` times ``embed_scale`` (``sqrt(d_model)``
with ``scale_embedding``) plus learned positions at ``position + 2``
(``_POS_OFFSET``, HF's offset; the decoder's start at
``position_offset``), then ``layernorm_embedding`` and dropout.
:class:`BartForConditionalGeneration` ties the head to ``shared`` and
adds the fp32 ``final_logits_bias`` (:324-363); :class:`BartForTextInfill`
adds the encoder's edit-operation head and :func:`text_infill_loss`
(:366-432).

Decode runs over :class:`..seq2seq_cache.Seq2SeqCache` (the
reference's ``init_cache``): self-attention K/V written at the cursor
and attended under ``slot <= query position`` (the decoder padding mask
is not read there, as in the reference, :150-154), the cross K/V
projected once on the priming call and read back under
``cross_from_cache``; the caller passes the step's ``position_offset``.

Compute runs in ``config.dtype`` over ``param_dtype`` parameters
(``models/layers.py``). Dropout draws per-site seeds from the
``dropout_rng`` host generator (``ops/dropout.py``). Parameter names are
the reference's flax paths (``model.encoder_layer_{i}.self_attn.q_proj``
and so on); ``convert.py`` maps HF checkpoints and the JAX package's
trees onto them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
from torch import nn

from fengshen_tpu_torch.models.layers import (Embed, dense, init_weights,
                                              linear, place, torch_dtype)
from fengshen_tpu_torch.models.seq2seq_cache import Seq2SeqCache
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.dropout import dropout, forward_seeds
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.masks import causal_mask
from fengshen_tpu_torch.ops.norms import LayerNorm
from fengshen_tpu_torch.parallel.cross_entropy import stable_cross_entropy

_POS_OFFSET = 2  # HF BartLearnedPositionalEmbedding offset

#: dropout sites per layer: the attention outputs (self, then cross in
#: the decoder) and the feed-forward output
ENCODER_SITES, DECODER_SITES = 2, 3


@dataclasses.dataclass
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    activation_function: str = "gelu"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    max_position_embeddings: int = 1024
    init_std: float = 0.02
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    decode_cache_length: int = 512

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
    def from_pretrained(cls, path: str) -> "BartConfig":
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
                      {"model_type": "bart"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "BartConfig":
        base = dict(vocab_size=128, d_model=32, encoder_layers=2,
                    decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64,
                    decoder_ffn_dim=64, max_position_embeddings=64)
        base.update(overrides)
        return cls(**base)


class BartAttention(nn.Module):
    def __init__(self, config, num_heads: int, causal: bool = False,
                 layer_idx: int = 0):
        super().__init__()
        self.config, self.num_heads, self.causal = config, num_heads, causal
        self.layer_idx = layer_idx
        d, p = config.d_model, config.param_dtype
        self.q_proj = linear(d, d, p)
        self.k_proj = linear(d, d, p)
        self.v_proj = linear(d, d, p)
        self.out_proj = linear(d, d, p)

    def forward(self, hidden, kv=None, attention_mask=None,
                cache: Optional[Seq2SeqCache] = None,
                cross_from_cache: bool = False):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        batch, q_len, _ = hidden.shape
        head_dim = cfg.d_model // self.num_heads
        q = dense(self.q_proj, hidden, dt).reshape(
            batch, q_len, self.num_heads, head_dim)
        if kv is not None and cache is not None and cross_from_cache:
            k, v = cache.cross(self.layer_idx)
        else:
            kv_in = hidden if kv is None else kv
            shape = (batch, kv_in.shape[1], self.num_heads, head_dim)
            k = dense(self.k_proj, kv_in, dt).reshape(shape)
            v = dense(self.v_proj, kv_in, dt).reshape(shape)
            if kv is not None and cache is not None:
                cache.set_cross(self.layer_idx, k, v)

        if self.causal and kv is None and cache is not None:
            offset = cache.index
            k, v = cache.write(self.layer_idx, k, v)
            # a one-token step sees every filled slot
            mask = None
            if q_len > 1:
                qpos = offset + torch.arange(q_len, device=hidden.device)
                mask = (torch.arange(k.shape[1], device=hidden.device)[
                    None, :] <= qpos[:, None])[None, None]
        elif self.causal:
            mask = causal_mask(q_len, k.shape[1],
                               device=hidden.device)[None, None]
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, None, :].bool()
        elif attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        else:
            mask = None
        out = dot_product_attention(q, k, v, mask=mask)
        return dense(self.out_proj, out.reshape(batch, q_len, cfg.d_model),
                     dt)


class BartEncoderLayer(nn.Module):
    def __init__(self, config: BartConfig):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        self.self_attn = BartAttention(config, config.encoder_attention_heads)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, config.encoder_ffn_dim, p)
        self.fc2 = linear(config.encoder_ffn_dim, d, p)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, hidden, attention_mask=None, seeds=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_attn, s_ff = seeds or (None, None)
        h = self.self_attn(hidden, attention_mask=attention_mask)
        hidden = self.self_attn_layer_norm(
            hidden + dropout(h, cfg.dropout, s_attn))
        h = get_activation(cfg.activation_function)(
            dense(self.fc1, hidden, dt))
        h = dense(self.fc2, h, dt)
        return self.final_layer_norm(hidden + dropout(h, cfg.dropout, s_ff))


class BartDecoderLayer(nn.Module):
    def __init__(self, config: BartConfig, layer_idx: int):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        heads = config.decoder_attention_heads
        self.self_attn = BartAttention(config, heads, causal=True,
                                       layer_idx=layer_idx)
        self.self_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = BartAttention(config, heads, layer_idx=layer_idx)
        self.encoder_attn_layer_norm = LayerNorm(d)
        self.fc1 = linear(d, config.decoder_ffn_dim, p)
        self.fc2 = linear(config.decoder_ffn_dim, d, p)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, hidden, encoder_hidden, attention_mask=None,
                encoder_attention_mask=None, cache=None,
                cross_from_cache=False, seeds=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_self, s_cross, s_ff = seeds or (None, None, None)
        h = self.self_attn(hidden, attention_mask=attention_mask,
                           cache=cache)
        hidden = self.self_attn_layer_norm(
            hidden + dropout(h, cfg.dropout, s_self))
        h = self.encoder_attn(hidden, kv=encoder_hidden,
                              attention_mask=encoder_attention_mask,
                              cache=cache, cross_from_cache=cross_from_cache)
        hidden = self.encoder_attn_layer_norm(
            hidden + dropout(h, cfg.dropout, s_cross))
        h = get_activation(cfg.activation_function)(
            dense(self.fc1, hidden, dt))
        h = dense(self.fc2, h, dt)
        return self.final_layer_norm(hidden + dropout(h, cfg.dropout, s_ff))


class BartModel(nn.Module):
    """Embeddings and both stacks (:252); ``with_decoder=False`` builds
    the encoder side alone (what the classification example's
    ``fengshen-bart`` runs through :meth:`encode`). ``device=None``
    means ``cuda`` and raises without a card; the weights are drawn
    there from ``generator`` (``init=False`` leaves them unwritten)."""

    def __init__(self, config: BartConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True, with_decoder: bool = True):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.param_dtype
        n_pos = config.max_position_embeddings + _POS_OFFSET
        with torch.device("meta"):
            self.shared = VocabParallelEmbed(config.vocab_size, d,
                                             param_dtype=torch_dtype(p))
            self.encoder_embed_positions = Embed(n_pos, d, p)
            self.encoder_layernorm_embedding = LayerNorm(d)
            for i in range(config.encoder_layers):
                setattr(self, f"encoder_layer_{i}", BartEncoderLayer(config))
            if with_decoder:
                self.decoder_embed_positions = Embed(n_pos, d, p)
                self.decoder_layernorm_embedding = LayerNorm(d)
                for i in range(config.decoder_layers):
                    setattr(self, f"decoder_layer_{i}",
                            BartDecoderLayer(config, i))
        self.embed_scale = (d ** 0.5) if config.scale_embedding else 1.0
        place(self, device, generator, init, config.init_std)

    def _layers(self, side: str) -> list:
        n = getattr(self.config, f"{side}_layers")
        return [getattr(self, f"{side}_layer_{i}") for i in range(n)]

    def _embed(self, ids, table, norm, offset, seed):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        pos = offset + torch.arange(ids.shape[1], device=ids.device) + \
            _POS_OFFSET
        hidden = self.shared(ids, dt) * self.embed_scale + table(pos, dt)[None]
        return dropout(norm(hidden), cfg.dropout, seed)

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        cfg = self.config
        embed_seed, layer_seeds = forward_seeds(
            dropout_rng, cfg.encoder_layers, ENCODER_SITES,
            not deterministic and cfg.dropout > 0.0)
        hidden = self._embed(input_ids, self.encoder_embed_positions,
                             self.encoder_layernorm_embedding, 0,
                             embed_seed)
        for layer, seeds in zip(self._layers("encoder"), layer_seeds):
            hidden = layer(hidden, attention_mask, seeds)
        return hidden

    def decode(self, decoder_input_ids, encoder_hidden, attention_mask=None,
               decoder_attention_mask=None, deterministic: bool = True,
               cache: Optional[Seq2SeqCache] = None,
               cross_from_cache: bool = False, position_offset: int = 0,
               dropout_rng=None):
        cfg = self.config
        embed_seed, layer_seeds = forward_seeds(
            dropout_rng, cfg.decoder_layers, DECODER_SITES,
            not deterministic and cfg.dropout > 0.0)
        hidden = self._embed(decoder_input_ids, self.decoder_embed_positions,
                             self.decoder_layernorm_embedding,
                             position_offset, embed_seed)
        for layer, seeds in zip(self._layers("decoder"), layer_seeds):
            hidden = layer(hidden, encoder_hidden, decoder_attention_mask,
                           attention_mask, cache, cross_from_cache, seeds)
        if cache is not None:
            cache.advance(decoder_input_ids.shape[1])
        return hidden

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng=None):
        """``(encoder output, decoder output)`` (:316)."""
        enc = self.encode(input_ids, attention_mask, deterministic,
                          dropout_rng)
        dec = self.decode(decoder_input_ids, enc, attention_mask,
                          decoder_attention_mask, deterministic,
                          dropout_rng=dropout_rng)
        return enc, dec


class _TiedHead(nn.Module):
    """A :class:`BartModel` under ``model`` with the head tied to
    ``shared`` plus the fp32 ``final_logits_bias``."""

    def __init__(self, config: BartConfig):
        super().__init__()
        self.config = config
        self.model = BartModel(config, device="meta", init=False)
        self.final_logits_bias = nn.Parameter(
            torch.zeros(config.vocab_size, dtype=torch.float32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.config.init_std)

    def _lm_logits(self, dec: torch.Tensor) -> torch.Tensor:
        logits = dec @ self.model.shared.weight.to(dec.dtype).T
        return logits + self.final_logits_bias.to(logits.dtype)

    @property
    def device(self) -> torch.device:
        return self.final_logits_bias.device


class BartForConditionalGeneration(_TiedHead):
    """The seq2seq head (:324). ``device=None`` means ``cuda``; the
    weights are drawn there from ``generator`` (``init=False`` leaves
    them unwritten)."""

    def __init__(self, config: BartConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        with torch.device("meta"):
            super().__init__(config)
        place(self, device, generator, init, config.init_std)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``[B, T, V]`` logits in the compute dtype (:333)."""
        _, dec = self.model(input_ids, decoder_input_ids, attention_mask,
                            decoder_attention_mask, deterministic,
                            dropout_rng)
        return self._lm_logits(dec)

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        return self.model.encode(input_ids, attention_mask, deterministic,
                                 dropout_rng)

    def decode_logits(self, decoder_input_ids, encoder_hidden,
                      attention_mask=None, deterministic: bool = True,
                      cache: Optional[Seq2SeqCache] = None,
                      cross_from_cache: bool = False,
                      position_offset: int = 0, dropout_rng=None):
        """The decoder and the head (:347); with ``cache`` the decode
        step of ``utils/generate.py`` at ``position_offset``."""
        dec = self.model.decode(decoder_input_ids, encoder_hidden,
                                attention_mask, None, deterministic, cache,
                                cross_from_cache, position_offset,
                                dropout_rng)
        return self._lm_logits(dec)

    def new_cache(self, rows: int, length: int) -> Seq2SeqCache:
        cfg = self.config
        return Seq2SeqCache.zeros(
            cfg.decoder_layers, rows, length, cfg.decoder_attention_heads,
            cfg.d_model // cfg.decoder_attention_heads, self.device,
            torch_dtype(cfg.dtype))


class BartForTextInfill(_TiedHead):
    """CBART's lexically constrained generation head (:366): the decoder
    reconstructs the sequence, and an encoder head (``classification_
    dense``, tanh, ``classification_out``) predicts each input token's
    edit operation (``num_labels`` classes, or one regression output
    with ``encoder_loss_type`` 1)."""

    def __init__(self, config: BartConfig, num_labels: int = 3,
                 encoder_loss_type: int = 0, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        with torch.device("meta"):
            super().__init__(config)
            out_dim = num_labels if encoder_loss_type == 0 else 1
            self.classification_dense = linear(config.d_model,
                                               config.d_model,
                                               config.param_dtype)
            self.classification_out = linear(config.d_model, out_dim,
                                             config.param_dtype)
        place(self, device, generator, init, config.init_std)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``(lm_logits [B, T, V], encoder_logits [B, S, labels])``."""
        dt = torch_dtype(self.config.dtype)
        enc, dec = self.model(input_ids, decoder_input_ids, attention_mask,
                              decoder_attention_mask, deterministic,
                              dropout_rng)
        lm_logits = dec @ self.model.shared.weight.to(dec.dtype).T + \
            self.final_logits_bias.to(dec.dtype)
        h = torch.tanh(dense(self.classification_dense, enc, dt))
        return lm_logits, dense(self.classification_out, h, dt)


def text_infill_loss(lm_logits, labels, encoder_logits, encoder_labels,
                     loss_weight: float = 1.0, label_weights=None,
                     encoder_loss_type: int = 0):
    """Decoder CE + ``loss_weight`` x the encoder's edit-operation loss
    (:410): a (label-weighted) CE over tokens whose label is not -100,
    or a squared error over insert counts >= 0."""
    dec_loss, _ = stable_cross_entropy(lm_logits, labels)
    if encoder_loss_type == 0:
        valid = encoder_labels != -100
        safe = torch.where(valid, encoder_labels, 0).long()
        logp = torch.log_softmax(encoder_logits.float(), -1)
        token_ce = -logp.gather(-1, safe[..., None])[..., 0]
        if label_weights is not None:
            token_ce = token_ce * torch.as_tensor(
                label_weights, dtype=torch.float32,
                device=token_ce.device)[safe]
        enc_loss = (token_ce * valid).sum() / valid.sum().clamp(min=1)
    else:
        valid = encoder_labels >= 0
        diff = (encoder_logits[..., 0] - encoder_labels.float()) ** 2
        enc_loss = (diff * valid).sum() / valid.sum().clamp(min=1)
    total = dec_loss + loss_weight * enc_loss
    return total, {"decoder_loss": dec_loss, "encoder_loss": enc_loss}
