"""DeBERTa-v2 in PyTorch: the port of
``fengshen_tpu/models/deberta_v2/modeling_deberta_v2.py``.

Disentangled attention (:146-214): content-to-content scores plus
content-to-position (c2p: each query against the relative-position
keys) and position-to-content (p2c: each key against the
relative-position queries) terms, gathered at the log-bucketed relative
position of every (query, key) pair; the scores are scaled by
``sqrt(head_dim * (1 + len(pos_att_type)))`` and taken in fp32. The
relative-position table ``rel_embeddings`` (``2 * position_buckets``
rows, LayerNorm'd with ``norm_rel_ebd="layer_norm"``) is shared by every
layer and projected by the layer's query/key projections
(``share_att_key``) or by its own ``pos_query_proj``/``pos_key_proj``.
Post-LN layers (:217-239); the model (:242-311): word embeddings
(position embeddings only with ``position_biased_input``), an embedding
LayerNorm, the input mask applied to the embeddings, and with
``conv_kernel_size`` a convolution branch beside layer 0.
:class:`DebertaV2ForMaskedLM` ties its decoder to the word embeddings
and adds a bias (:313-334); :class:`DebertaV2ForSequenceClassification`
pools ``[CLS]`` through ``pooler_dense`` and tanh (:337-355).

The bucket table (:func:`build_relative_position`) is computed on the
host in fp32 exactly as the JAX package computes it, then moved to the
activations' device, so it is the same table bitwise on every device.

Dtypes, names, placement and dropout follow ``models/layers.py`` and
``ops/dropout.py``, as in ``models/megatron_bert``: compute in
``config.dtype`` over ``param_dtype`` parameters; parameter names are
the reference's flax paths (``layer_{i}``, ``self.query_proj``, ...).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.models.layers import (Embed, dense, linear, place,
                                              torch_dtype)
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.dropout import (dropout, forward_seeds,
                                            site_generator, site_seeds)
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm

#: dropout sites per layer: attention probabilities, attention output,
#: feed-forward output
LAYER_SITES = 3


@dataclasses.dataclass
class DebertaV2Config:
    """The port's own copy of the reference's ``DebertaV2Config`` (same
    fields and defaults, :40-108). ``pos_att_type`` may be given as
    HF's ``"p2c|c2p"`` string."""

    vocab_size: int = 128100
    hidden_size: int = 1536
    num_hidden_layers: int = 24
    num_attention_heads: int = 24
    intermediate_size: int = 6144
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-7
    relative_attention: bool = True
    max_relative_positions: int = -1
    position_buckets: int = 256
    norm_rel_ebd: str = "layer_norm"
    share_att_key: bool = True
    pos_att_type: tuple = ("p2c", "c2p")
    position_biased_input: bool = False
    conv_kernel_size: int = 0
    conv_act: str = "tanh"
    pad_token_id: int = 0
    num_labels: int = 2
    pooler_hidden_size: Optional[int] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.max_relative_positions < 1:
            self.max_relative_positions = self.max_position_embeddings
        if self.pooler_hidden_size is None:
            self.pooler_hidden_size = self.hidden_size
        if isinstance(self.pos_att_type, str):
            self.pos_att_type = tuple(
                x.strip() for x in self.pos_att_type.split("|") if x)
        self.pos_att_type = tuple(self.pos_att_type)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pos_ebd_size(self) -> int:
        return self.position_buckets if self.position_buckets > 0 \
            else self.max_relative_positions

    @classmethod
    def from_pretrained(cls, path: str) -> "DebertaV2Config":
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
                      {"model_type": "deberta-v2"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "DebertaV2Config":
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64, position_buckets=8)
        base.update(overrides)
        return cls(**base)


def make_log_bucket_position(relative_pos: torch.Tensor, bucket_size: int,
                             max_position: int) -> torch.Tensor:
    """HF's log buckets (:121): positions inside ``bucket_size // 2``
    keep their value, the rest go to ``mid + ceil(log(|r| / mid) /
    log((max_position - 1) / mid) * (mid - 1))`` with their sign; fp32
    throughout, the divisor rounded from float64 as the JAX package
    rounds it. Returns int32."""
    sign = torch.sign(relative_pos)
    mid = bucket_size // 2
    inside = (relative_pos < mid) & (relative_pos > -mid)
    abs_pos = torch.where(inside, torch.full_like(relative_pos, mid - 1),
                          relative_pos.abs()).to(torch.float32)
    divisor = torch.tensor(np.log((max_position - 1) / mid),
                           dtype=torch.float32)
    log_pos = torch.ceil(torch.log(abs_pos / mid) / divisor * (mid - 1)) \
        + mid
    bucket_pos = torch.where(abs_pos <= mid,
                             relative_pos.to(torch.float32), log_pos * sign)
    return bucket_pos.to(torch.int32)


@functools.lru_cache(maxsize=16)
def _relative_position_cpu(q_len: int, k_len: int, bucket_size: int,
                           max_position: int) -> torch.Tensor:
    rel = torch.arange(q_len)[:, None] - torch.arange(k_len)[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel.to(torch.int32)


def build_relative_position(q_len: int, k_len: int, bucket_size: int,
                            max_position: int, device=None) -> torch.Tensor:
    """``[q_len, k_len]`` int32 relative positions ``q - k``, log
    bucketed when ``bucket_size`` and ``max_position`` are positive
    (:137); computed on the host, then put on ``device``."""
    rel = _relative_position_cpu(q_len, k_len, bucket_size, max_position)
    return rel if device is None else rel.to(device)


class DisentangledSelfAttention(nn.Module):
    """``query_proj``, ``key_proj``, ``value_proj`` (and, without
    ``share_att_key``, ``pos_query_proj`` and ``pos_key_proj``)."""

    def __init__(self, config: DebertaV2Config):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        self.query_proj = linear(h, h, p)
        self.key_proj = linear(h, h, p)
        self.value_proj = linear(h, h, p)
        if config.relative_attention and not config.share_att_key:
            self.pos_query_proj = linear(h, h, p)
            self.pos_key_proj = linear(h, h, p)

    def forward(self, hidden, mask, rel_embeddings, relative_pos,
                seed: Optional[int] = None):
        """``mask`` bool ``[B, 1, 1, S]`` (or None); ``relative_pos``
        ``[S, S]``; ``seed`` the attention-dropout site's seed or None.
        Returns ``[B, S, hidden]`` in the compute dtype."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        batch, seq, _ = hidden.shape
        n_head, head_dim = cfg.num_attention_heads, cfg.head_dim
        q = dense(self.query_proj, hidden, dt).view(batch, seq, n_head,
                                                     head_dim)
        k = dense(self.key_proj, hidden, dt).view(batch, seq, n_head,
                                                   head_dim)
        v = dense(self.value_proj, hidden, dt).view(batch, seq, n_head,
                                                     head_dim)
        scale = torch.sqrt(torch.tensor(
            float(head_dim * (1 + len(cfg.pos_att_type))),
            dtype=torch.float32))
        qf, kf = q.float(), k.float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / scale

        if cfg.relative_attention:
            span = cfg.pos_ebd_size
            rel_emb = rel_embeddings[: span * 2]
            if cfg.share_att_key:
                pos_q_proj, pos_k_proj = self.query_proj, self.key_proj
            else:
                pos_q_proj, pos_k_proj = self.pos_query_proj, \
                    self.pos_key_proj
            index_shape = (batch, n_head) + tuple(relative_pos.shape)
            if "c2p" in cfg.pos_att_type:
                pos_k = dense(pos_k_proj, rel_emb, dt).view(-1, n_head,
                                                            head_dim)
                c2p = torch.einsum("bqhd,phd->bhqp", qf, pos_k.float())
                c2p_pos = (relative_pos.long() + span).clamp(0, span * 2 - 1)
                scores = scores + torch.gather(
                    c2p, -1, c2p_pos.expand(index_shape)) / scale
            if "p2c" in cfg.pos_att_type:
                pos_q = dense(pos_q_proj, rel_emb, dt).view(-1, n_head,
                                                            head_dim)
                p2c = torch.einsum("bkhd,phd->bhkp", kf, pos_q.float())
                p2c_pos = (-relative_pos.long() + span).clamp(0,
                                                              span * 2 - 1)
                scores = scores + torch.gather(
                    p2c, -1, p2c_pos.expand(index_shape)).transpose(-1, -2) \
                    / scale

        if mask is not None:
            scores = torch.where(mask, scores,
                                 torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        rate = cfg.attention_probs_dropout_prob
        if seed is not None and rate > 0:
            keep = torch.rand(probs.shape,
                              generator=site_generator(seed, probs.device),
                              device=probs.device) < 1.0 - rate
            probs = torch.where(keep, probs / (1.0 - rate), 0.0)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return out.reshape(batch, seq, cfg.hidden_size)


class DebertaV2Layer(nn.Module):
    """Post-LN: ``attention_ln(h + dense(attention(h)))``, then
    ``output_ln(h + dense(act(dense(h))))`` (:217)."""

    def __init__(self, config: DebertaV2Config):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        self.self = DisentangledSelfAttention(config)
        self.attention_output_dense = linear(h, h, p)
        self.attention_ln = LayerNorm(h, config.layer_norm_eps)
        self.intermediate_dense = linear(h, config.intermediate_size, p)
        self.output_dense = linear(config.intermediate_size, h, p)
        self.output_ln = LayerNorm(h, config.layer_norm_eps)

    def forward(self, hidden, mask, rel_embeddings, relative_pos,
                seeds=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_probs, s_attn, s_ffn = seeds or (None, None, None)
        h = self.self(hidden, mask, rel_embeddings, relative_pos, s_probs)
        h = dense(self.attention_output_dense, h, dt)
        h = dropout(h, cfg.hidden_dropout_prob, s_attn)
        hidden = self.attention_ln(hidden + h)
        h = dense(self.intermediate_dense, hidden, dt)
        h = dense(self.output_dense, get_activation(cfg.hidden_act)(h), dt)
        h = dropout(h, cfg.hidden_dropout_prob, s_ffn)
        return self.output_ln(hidden + h)


class DebertaV2Model(nn.Module):
    """The encoder (:242): ``forward`` returns the hidden states ``[B,
    S, H]`` in the compute dtype. ``device=None`` means ``cuda`` and
    raises without a card; the weights are drawn there from
    ``generator`` (``init=False`` leaves them unwritten, for a
    loader)."""

    def __init__(self, config: DebertaV2Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        with torch.device("meta"):
            self.word_embeddings = VocabParallelEmbed(
                config.vocab_size, h, param_dtype=torch_dtype(p))
            if config.position_biased_input:
                self.position_embeddings = Embed(
                    config.max_position_embeddings, h, p)
            self.embeddings_ln = LayerNorm(h, config.layer_norm_eps)
            if config.relative_attention:
                self.rel_embeddings = nn.Parameter(torch.empty(
                    config.pos_ebd_size * 2, h, dtype=torch_dtype(p)))
                if "layer_norm" in config.norm_rel_ebd:
                    self.rel_embeddings_ln = LayerNorm(
                        h, config.layer_norm_eps)
            for i in range(config.num_hidden_layers):
                setattr(self, f"layer_{i}", DebertaV2Layer(config))
            if config.conv_kernel_size > 0:
                self.conv = nn.Conv1d(h, h, config.conv_kernel_size,
                                      dtype=torch_dtype(p))
                self.conv_ln = LayerNorm(h, config.layer_norm_eps)
        place(self, device, generator, init, config.initializer_range)

    def layers(self) -> list:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def init_own_parameters(self, generator: torch.Generator,
                            std: float) -> None:
        """The relative-position table N(0, ``std``), for
        ``models/layers.init_weights``."""
        if self.config.relative_attention:
            self.rel_embeddings.normal_(0.0, std, generator=generator)

    def _conv(self, prev, mask_f, seed):
        """The branch beside layer 0 (:292-305): a 'SAME' convolution of
        the layer's input, masked, dropped out and activated."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        k = cfg.conv_kernel_size
        left = (k - 1) // 2
        x = F.pad(prev.to(dt).transpose(1, 2), (left, k - 1 - left))
        conv = F.conv1d(x, self.conv.weight.to(dt),
                        self.conv.bias.to(dt)).transpose(1, 2)
        conv = conv * mask_f.to(conv.dtype)
        return get_activation(cfg.conv_act)(
            dropout(conv, cfg.hidden_dropout_prob, seed))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        del token_type_ids
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        batch, seq = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        active = not deterministic and bool(
            cfg.hidden_dropout_prob or cfg.attention_probs_dropout_prob)
        embed_seed, layer_seeds = forward_seeds(
            dropout_rng, cfg.num_hidden_layers, LAYER_SITES, active)
        conv_seed = site_seeds(dropout_rng, 1)[0] \
            if active and cfg.conv_kernel_size > 0 else None
        hidden = self.word_embeddings(input_ids, dt)
        if cfg.position_biased_input:
            pos = torch.arange(seq, device=input_ids.device)[None]
            hidden = hidden + self.position_embeddings(pos, dt)
        hidden = self.embeddings_ln(hidden)
        mask_f = attention_mask[..., None]
        hidden = hidden * mask_f.to(hidden.dtype)
        hidden = dropout(hidden, cfg.hidden_dropout_prob, embed_seed)

        rel_embeddings = relative_pos = None
        if cfg.relative_attention:
            rel_embeddings = self.rel_embeddings
            if "layer_norm" in cfg.norm_rel_ebd:
                rel_embeddings = self.rel_embeddings_ln(rel_embeddings)
            relative_pos = build_relative_position(
                seq, seq, cfg.position_buckets, cfg.max_relative_positions,
                device=input_ids.device)
        mask = attention_mask[:, None, None, :].bool()
        for i, (layer, seeds) in enumerate(zip(self.layers(), layer_seeds)):
            prev = hidden
            hidden = layer(hidden, mask, rel_embeddings, relative_pos, seeds)
            if i == 0 and cfg.conv_kernel_size > 0:
                hidden = self.conv_ln(hidden + self._conv(prev, mask_f,
                                                          conv_seed))
                hidden = hidden * mask_f.to(hidden.dtype)
        return hidden


def _with_encoder(module: nn.Module, config, device, generator, init,
                  build_head) -> None:
    """Build ``deberta`` and the head on ``meta``, then place both."""
    with torch.device("meta"):
        module.deberta = DebertaV2Model(config, device="meta", init=False)
        build_head()
    place(module, device, generator, init, config.initializer_range)


class DebertaV2ForMaskedLM(nn.Module):
    """``deberta``, then ``transform_dense``, the activation,
    ``transform_ln``, the decoder tied to the word embeddings and
    ``bias``: fp32 logits ``[B, S, V]``."""

    def __init__(self, config: DebertaV2Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype

        def head():
            self.transform_dense = linear(h, h, p)
            self.transform_ln = LayerNorm(h, config.layer_norm_eps)
            self.bias = nn.Parameter(torch.empty(config.vocab_size,
                                                 dtype=torch_dtype(p)))

        _with_encoder(self, config, device, generator, init, head)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        hidden = self.deberta(input_ids, attention_mask, token_type_ids,
                              deterministic, dropout_rng)
        h = dense(self.transform_dense, hidden, dt)
        h = self.transform_ln(get_activation(cfg.hidden_act)(h))
        return h @ self.deberta.word_embeddings.weight.to(h.dtype).T \
            + self.bias


class DebertaV2ForSequenceClassification(nn.Module):
    """Dropout on ``[CLS]``, ``pooler_dense`` and tanh, dropout, then
    ``classifier`` to ``config.num_labels`` (:337, HF's
    ``ContextPooler``)."""

    def __init__(self, config: DebertaV2Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype

        def head():
            self.pooler_dense = linear(h, config.pooler_hidden_size, p)
            self.classifier = linear(config.pooler_hidden_size,
                                     config.num_labels, p)

        _with_encoder(self, config, device, generator, init, head)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        hidden = self.deberta(input_ids, attention_mask, token_type_ids,
                              deterministic, dropout_rng)
        s1, s2 = site_seeds(dropout_rng, 2) if not deterministic and \
            cfg.hidden_dropout_prob else (None, None)
        pooled = dropout(hidden[:, 0], cfg.hidden_dropout_prob, s1)
        pooled = torch.tanh(dense(self.pooler_dense, pooled, dt))
        pooled = dropout(pooled, cfg.hidden_dropout_prob, s2)
        return dense(self.classifier, pooled, dt)
