"""MegatronBert in PyTorch: the port of
``fengshen_tpu/models/megatron_bert/modeling_megatron_bert.py``.

Pre-LN layers (:104-126): ``h + dense(dropout(attention(ln(h))))``, then
``h + dropout(dense(act(dense(ln(h)))))``; embeddings word + position +
token type, then dropout, with no embedding LayerNorm (:146-165); a
final ``ln`` and the tanh pooler over ``[CLS]`` (:186-196). The
attention mask is a ``[B, S]`` padding mask or a per-sample ``[B, S, S]``
mask (:81-89), turned into the -1e9 bias of the dense attention, whose
scores and softmax are fp32. Heads: :class:`MLMHead` with the decoder
tied to the word embeddings, :class:`MegatronBertForPreTraining` (MLM +
sentence order), ``ForMaskedLM``, ``ForSequenceClassification`` and
``ForTokenClassification``; ``task_heads.py`` adds question answering
and multiple choice.

Compute runs in ``config.dtype`` over ``param_dtype`` parameters
(``models/layers.py``). With ``gradient_checkpointing`` every layer is
recomputed in the backward (``torch.utils.checkpoint``, keeping only its
input: the reference's ``nothing_saveable``, :171-186). Dropout draws
per-site seeds from the ``dropout_rng`` host generator
(``ops/dropout.py``); ``deterministic=True`` turns it off. Parameter
names are the reference's flax paths (``layer_{i}`` per layer whatever
``scan_layers`` says); ``convert.py`` maps HF checkpoints and the JAX
package's trees onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fengshen_tpu_torch.models.layers import (Embed, attention_mask_bool,
                                              dense, linear, place,
                                              torch_dtype)
from fengshen_tpu_torch.models.megatron_bert.configuration_megatron_bert \
    import MegatronBertConfig
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.dropout import dropout, forward_seeds, \
    site_generator, site_seeds
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm

#: dropout sites per layer: attention probabilities, attention output,
#: feed-forward output
LAYER_SITES = 3


def encoder_seeds(config, n_layers: int, deterministic: bool,
                  dropout_rng: Optional[torch.Generator]) -> tuple:
    """``(embedding seed, [per-layer seed triples])`` for one forward:
    Nones when ``deterministic`` or every rate is 0; a forward that
    drops out without ``dropout_rng`` raises, as flax does without a
    ``"dropout"`` rng."""
    rates = (config.hidden_dropout_prob, config.attention_probs_dropout_prob)
    return forward_seeds(dropout_rng, n_layers, LAYER_SITES,
                         not deterministic and any(rates))


def head_seed(config, deterministic: bool,
              dropout_rng: Optional[torch.Generator]) -> Optional[int]:
    """The seed of a head's own dropout site (drawn after the
    encoder's)."""
    if deterministic or not config.hidden_dropout_prob:
        return None
    return site_seeds(dropout_rng, 1)[0]


def self_attention(layer, hidden, mask, seed, config) -> torch.Tensor:
    """q, k, v projections of ``layer`` (``query``/``key``/``value``),
    dense attention with the bool ``mask`` and the attention-dropout
    site ``seed``, heads merged back to ``[B, S, hidden]``."""
    dt = torch_dtype(config.dtype)
    batch, seq, _ = hidden.shape
    shape = (batch, seq, config.num_attention_heads, config.head_dim)
    q = dense(layer.query, hidden, dt).view(shape)
    k = dense(layer.key, hidden, dt).view(shape)
    v = dense(layer.value, hidden, dt).view(shape)
    out = dot_product_attention(
        q, k, v, mask=mask, dropout_rng=site_generator(seed, q.device),
        dropout_rate=config.attention_probs_dropout_prob,
        deterministic=seed is None)
    return out.reshape(batch, seq, config.hidden_size)


class MegatronBertSelfAttention(nn.Module):
    def __init__(self, config: MegatronBertConfig):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        self.query = linear(h, h, p)
        self.key = linear(h, h, p)
        self.value = linear(h, h, p)

    def forward(self, hidden, mask=None, seed=None):
        return self_attention(self, hidden, mask, seed, self.config)


class MegatronBertLayer(nn.Module):
    def __init__(self, config: MegatronBertConfig):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        self.attention_ln = LayerNorm(h, config.layer_norm_eps)
        self.self = MegatronBertSelfAttention(config)
        self.attention_output_dense = linear(h, h, p)
        self.ln = LayerNorm(h, config.layer_norm_eps)
        self.intermediate_dense = linear(h, config.intermediate_size, p)
        self.output_dense = linear(config.intermediate_size, h, p)

    def forward(self, hidden, mask=None, seeds=None):
        """``mask`` bool (``attention_mask_bool``); ``seeds`` the three
        dropout sites' seeds, or None."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_probs, s_attn, s_ffn = seeds or (None, None, None)
        h = self.self(self.attention_ln(hidden), mask, s_probs)
        h = dense(self.attention_output_dense, h, dt)
        hidden = hidden + dropout(h, cfg.hidden_dropout_prob, s_attn)
        h = dense(self.intermediate_dense, self.ln(hidden), dt)
        h = dense(self.output_dense, get_activation(cfg.hidden_act)(h), dt)
        return hidden + dropout(h, cfg.hidden_dropout_prob, s_ffn)


class MegatronBertModel(nn.Module):
    """The encoder (:137). ``device=None`` means ``cuda`` and raises
    without a card; the weights are drawn there from ``generator``
    (``init=False`` leaves them unwritten, for a loader)."""

    def __init__(self, config: MegatronBertConfig,
                 add_pooling_layer: bool = True, device=None,
                 generator: Optional[torch.Generator] = None,
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
            for i in range(config.num_hidden_layers):
                setattr(self, f"layer_{i}", MegatronBertLayer(config))
            self.ln = LayerNorm(h, config.layer_norm_eps)
            self.pooler = linear(h, h, p) if add_pooling_layer else None
        place(self, device, generator, init, config.initializer_range)

    def layers(self) -> list:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_hidden_layers)]

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``(hidden [B, S, H], pooled [B, H] or None)`` in the compute
        dtype."""
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
        hidden = dropout(hidden, cfg.hidden_dropout_prob, embed_seed)
        mask = attention_mask_bool(attention_mask)
        remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
        for layer, seeds in zip(self.layers(), layer_seeds):
            if remat:
                hidden = checkpoint(layer, hidden, mask, seeds,
                                    use_reentrant=False)
            else:
                hidden = layer(hidden, mask, seeds)
        hidden = self.ln(hidden)
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(dense(self.pooler, hidden[:, 0], dt))
        return hidden, pooled


class MLMHead(nn.Module):
    """``cls.predictions``: dense + activation + LN, the decoder tied to
    the word embeddings, and a ``bias [V]`` in ``param_dtype``; the
    logits come out in fp32 (the compute-dtype product plus the bias,
    as in the reference)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        h, p = config.hidden_size, config.param_dtype
        self.transform_dense = linear(h, h, p)
        self.transform_ln = LayerNorm(h, config.layer_norm_eps)
        self.bias = nn.Parameter(torch.empty(config.vocab_size,
                                             dtype=torch_dtype(p)))

    def forward(self, hidden, word_embedding: torch.Tensor):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        h = dense(self.transform_dense, hidden, dt)
        h = self.transform_ln(get_activation(cfg.hidden_act)(h))
        return h @ word_embedding.to(h.dtype).T + self.bias


class _WithEncoder(nn.Module):
    """A head over ``bert`` (a :class:`MegatronBertModel`), built and
    placed as the encoder is."""

    pooling = True

    def __init__(self, config: MegatronBertConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.bert = MegatronBertModel(config, self.pooling,
                                          device="meta", init=False)
            self.build_head(config)
        place(self, device, generator, init, config.initializer_range)

    def build_head(self, config) -> None:
        raise NotImplementedError


class MegatronBertForPreTraining(_WithEncoder):
    """MLM + sentence-order head (the Erlangshen pretrain objective):
    ``(mlm_logits [B, S, V] fp32, sop_logits [B, 2])``."""

    def build_head(self, config) -> None:
        self.cls_predictions = MLMHead(config)
        self.cls_seq_relationship = linear(config.hidden_size, 2,
                                           config.param_dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic=True, dropout_rng=None):
        hidden, pooled = self.bert(input_ids, attention_mask,
                                     token_type_ids, position_ids,
                                     deterministic, dropout_rng)
        mlm = self.cls_predictions(hidden, self.bert.word_embeddings.weight)
        sop = dense(self.cls_seq_relationship, pooled,
                    torch_dtype(self.config.dtype))
        return mlm, sop


class MegatronBertForMaskedLM(_WithEncoder):
    pooling = False

    def build_head(self, config) -> None:
        self.cls_predictions = MLMHead(config)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic=True, dropout_rng=None,
                return_hidden: bool = False):
        hidden, _ = self.bert(input_ids, attention_mask, token_type_ids,
                                position_ids, deterministic, dropout_rng)
        logits = self.cls_predictions(hidden,
                                      self.bert.word_embeddings.weight)
        return (logits, hidden) if return_hidden else logits


class MegatronBertForSequenceClassification(_WithEncoder):
    """Dropout on the pooled ``[CLS]``, then ``classifier`` to
    ``config.num_labels``."""

    def build_head(self, config) -> None:
        self.classifier = linear(config.hidden_size, config.num_labels,
                                 config.param_dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic=True, dropout_rng=None):
        cfg = self.config
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                                position_ids, deterministic, dropout_rng)
        pooled = dropout(pooled, cfg.hidden_dropout_prob,
                         head_seed(cfg, deterministic, dropout_rng))
        return dense(self.classifier, pooled, torch_dtype(cfg.dtype))


class MegatronBertForTokenClassification(_WithEncoder):
    pooling = False

    def build_head(self, config) -> None:
        self.classifier = linear(config.hidden_size, config.num_labels,
                                 config.param_dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic=True, dropout_rng=None):
        cfg = self.config
        hidden, _ = self.bert(input_ids, attention_mask, token_type_ids,
                                position_ids, deterministic, dropout_rng)
        hidden = dropout(hidden, cfg.hidden_dropout_prob,
                         head_seed(cfg, deterministic, dropout_rng))
        return dense(self.classifier, hidden, torch_dtype(cfg.dtype))
