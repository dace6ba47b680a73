"""T5 in PyTorch: the port of ``fengshen_tpu/models/t5/modeling_t5.py``
(Randeng's Megatron-T5 and the HF-T5-based summary, QA and pretraining
examples).

Pre-norm blocks (:229-260): ``h + dropout(attn(ln_self(h)))``, in the
decoder ``h + dropout(cross(ln_cross(h), encoder))``, then ``h +
dropout(ff(ln_ff(h)))``; each stack drops out its input, ends in a
``final_layer_norm`` and drops out its output (:263-290).
:class:`T5LayerNorm` (:46-59) is an RMS norm in fp32 that multiplies by
the fp32 ``scale`` before it casts back. The attention (:83-204):

- is unscaled (the ``1/sqrt(d)`` lives in the initialisation);
- takes fp32 scores from the compute-dtype q and k, adds a bias built
  in fp32 in this order: the relative position bias, -1e9 where the
  causal (or, over the cache, the decode) mask is False, -1e9 where the
  ``[B, S]`` padding mask is 0; then an fp32 softmax, dropout on the
  probabilities, and the probabilities cast to v's dtype before PV;
- owns a relative-bias table (``relative_attention_bias``, buckets x
  heads) in block 0 of each stack only; block 0 computes the bias
  (:func:`relative_position_bucket`, bidirectional in the encoder) and
  hands it to every later block (:134-150, :278-288). Cross-attention
  has no position bias.

Decode runs over :class:`..seq2seq_cache.Seq2SeqCache` (the
reference's ``init_cache``): self-attention K/V written at the cursor,
the bias taken at query positions ``index + arange(S)``; the cross K/V
projected once on the priming call and read back under
``cross_from_cache`` (:102-119). The feed-forward (:206-226) is ``wo(
dropout(act(wi(h))))`` or, gated, ``act(wi_0(h)) * wi_1(h)``, with
``"gelu"`` meaning the tanh form (``gelu_new``). The tied head rescales
the decoder output by ``d_model ** -0.5`` (:344-351).

Compute runs in ``config.dtype`` over ``param_dtype`` parameters
(``models/layers.py``). Dropout draws per-site seeds from the
``dropout_rng`` host generator (``ops/dropout.py``);
``deterministic=True`` turns it off. There is no per-block remat, as in
the reference. Parameter names are the reference's flax paths
(``model.encoder.block_{i}.self_attention.q`` and so on); ``convert.py``
maps HF checkpoints and the JAX package's trees onto them. No kernel of
the port lies on this path, as no Pallas kernel does in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.layers import Embed, dense, linear, \
    torch_dtype
from fengshen_tpu_torch.models.seq2seq_cache import Seq2SeqCache
from fengshen_tpu_torch.models.t5.configuration_t5 import T5Config
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.dropout import (dropout, forward_seeds,
                                            site_seeds)
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.masks import causal_mask

#: dropout sites per block: attention probabilities and output (twice
#: in the decoder: self, then cross), the feed-forward's inner
#: activation and output
ENCODER_SITES, DECODER_SITES = 4, 6


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction or bias (:46): fp32 statistics,
    times the fp32 ``weight`` (the reference's ``scale``), then cast
    back to the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.epsilon)
        return (y * self.weight).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5's bucket of each relative position (key minus query,
    :62-80): exact below ``num_buckets // 2`` (halved first when
    bidirectional, the sign taking the upper half), log-spaced up to
    ``max_distance``, fp32 ``log`` truncated to an integer."""
    ret = 0
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) /
        math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32).long()
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _bias_mask(bias: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return bias + torch.where(keep, 0.0, -1e9)


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False,
                 causal: bool = False, layer_idx: int = 0):
        super().__init__()
        self.config = config
        self.has_relative_bias, self.causal = has_relative_bias, causal
        self.layer_idx = layer_idx
        d, inner, p = config.d_model, config.num_heads * config.d_kv, \
            config.param_dtype
        self.q = linear(d, inner, p, bias=False)
        self.k = linear(d, inner, p, bias=False)
        self.v = linear(d, inner, p, bias=False)
        self.o = linear(inner, d, p, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = Embed(
                config.relative_attention_num_buckets, config.num_heads, p)

    def _relative_bias(self, q_len: int, k_len: int, offset: int,
                       device) -> torch.Tensor:
        """``[1, heads, q_len, k_len]`` fp32 bias for queries at
        ``offset + arange(q_len)`` (:142-150)."""
        cfg = self.config
        qpos = (offset + torch.arange(q_len, device=device))[:, None]
        rel = torch.arange(k_len, device=device)[None, :] - qpos
        buckets = relative_position_bucket(
            rel, bidirectional=not self.causal,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)
        return self.relative_attention_bias(
            buckets, torch.float32).permute(2, 0, 1)[None]

    def forward(self, hidden, kv=None, mask=None, position_bias=None,
                cache: Optional[Seq2SeqCache] = None,
                cross_from_cache: bool = False, seed=None):
        """``hidden [B, S, d]``; ``kv`` the encoder output (cross
        attention) or None; ``mask`` a ``[B, K]`` padding mask or None;
        ``position_bias`` the bias block 0 returned. Returns ``(out,
        position_bias)``."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        batch, q_len, _ = hidden.shape
        heads, d_kv = cfg.num_heads, cfg.d_kv
        inner = heads * d_kv
        q = dense(self.q, hidden, dt).reshape(batch, q_len, heads, d_kv)
        if kv is not None and cache is not None and cross_from_cache:
            k, v = cache.cross(self.layer_idx)
        else:
            kv_in = hidden if kv is None else kv
            shape = (batch, kv_in.shape[1], heads, d_kv)
            k = dense(self.k, kv_in, dt).reshape(shape)
            v = dense(self.v, kv_in, dt).reshape(shape)
            if kv is not None and cache is not None:
                cache.set_cross(self.layer_idx, k, v)

        use_cache = self.causal and kv is None and cache is not None
        offset = 0
        if use_cache:
            offset = cache.index
            k, v = cache.write(self.layer_idx, k, v)
        k_len = k.shape[1]
        if position_bias is None and self.has_relative_bias:
            position_bias = self._relative_bias(q_len, k_len, offset,
                                                hidden.device)
        bias = None if position_bias is None else position_bias.float()
        if self.causal and kv is None and not (use_cache and q_len == 1):
            # the decode mask over the cache is the causal mask shifted
            # to the cursor (a one-token step sees every filled slot)
            qpos = offset + torch.arange(q_len, device=hidden.device)
            keep = torch.arange(k_len, device=hidden.device)[None, :] <= \
                qpos[:, None] if use_cache else causal_mask(
                    q_len, k_len, device=hidden.device)
            bias = _bias_mask(0.0 if bias is None else bias,
                              keep[None, None])
        if mask is not None:
            bias = _bias_mask(0.0 if bias is None else bias,
                              mask[:, None, None, :].bool())

        # T5 attention is UNSCALED (the 1/sqrt(d) is folded into init)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if bias is not None:
            scores = scores + bias
        probs = dropout(torch.softmax(scores, dim=-1), cfg.dropout_rate,
                        seed)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        out = dense(self.o, out.reshape(batch, q_len, inner), dt)
        return out, position_bias


class T5FF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        d, f, p = config.d_model, config.d_ff, config.param_dtype
        if config.is_gated_act:
            self.wi_0 = linear(d, f, p, bias=False)
            self.wi_1 = linear(d, f, p, bias=False)
        else:
            self.wi = linear(d, f, p, bias=False)
        self.wo = linear(f, d, p, bias=False)
        fn = config.dense_act_fn
        self.act = get_activation("gelu_new" if fn == "gelu" else fn)

    def forward(self, hidden, seed=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        if cfg.is_gated_act:
            h = self.act(dense(self.wi_0, hidden, dt)) * \
                dense(self.wi_1, hidden, dt)
        else:
            h = self.act(dense(self.wi, hidden, dt))
        h = dropout(h, cfg.dropout_rate, seed)
        return dense(self.wo, h, dt)


class T5Block(nn.Module):
    def __init__(self, config: T5Config, layer_idx: int, causal: bool):
        super().__init__()
        self.config, self.causal = config, causal
        eps = config.layer_norm_epsilon
        self.ln_self = T5LayerNorm(config.d_model, eps)
        self.self_attention = T5Attention(
            config, has_relative_bias=layer_idx == 0, causal=causal,
            layer_idx=layer_idx)
        if causal:
            self.ln_cross = T5LayerNorm(config.d_model, eps)
            self.cross_attention = T5Attention(config, layer_idx=layer_idx)
        self.ln_ff = T5LayerNorm(config.d_model, eps)
        self.ff = T5FF(config)

    def forward(self, hidden, mask=None, encoder_hidden=None,
                encoder_mask=None, position_bias=None, cache=None,
                cross_from_cache=False, seeds=None):
        rate = self.config.dropout_rate
        if seeds is None:
            seeds = (None,) * (DECODER_SITES if self.causal
                               else ENCODER_SITES)
        seeds = list(seeds)
        h, position_bias = self.self_attention(
            self.ln_self(hidden), mask=mask, position_bias=position_bias,
            cache=cache, seed=seeds.pop(0))
        hidden = hidden + dropout(h, rate, seeds.pop(0))
        if self.causal:
            h, _ = self.cross_attention(
                self.ln_cross(hidden), kv=encoder_hidden, mask=encoder_mask,
                cache=cache, cross_from_cache=cross_from_cache,
                seed=seeds.pop(0))
            hidden = hidden + dropout(h, rate, seeds.pop(0))
        h = self.ff(self.ln_ff(hidden), seed=seeds.pop(0))
        return hidden + dropout(h, rate, seeds.pop(0)), position_bias


class T5Stack(nn.Module):
    """The encoder or the decoder stack (:263)."""

    def __init__(self, config: T5Config, causal: bool):
        super().__init__()
        self.config, self.causal = config, causal
        self.n_layers = config.num_decoder_layers if causal \
            else config.num_layers
        for i in range(self.n_layers):
            setattr(self, f"block_{i}", T5Block(config, i, causal))
        self.final_layer_norm = T5LayerNorm(config.d_model,
                                            config.layer_norm_epsilon)

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def forward(self, hidden, mask=None, encoder_hidden=None,
                encoder_mask=None, cache=None, cross_from_cache=False,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        cfg = self.config
        sites = DECODER_SITES if self.causal else ENCODER_SITES
        active = not deterministic and cfg.dropout_rate > 0.0
        in_seed, block_seeds = forward_seeds(dropout_rng, self.n_layers,
                                             sites, active)
        out_seed = site_seeds(dropout_rng if active else None, 1)[0]
        hidden = dropout(hidden, cfg.dropout_rate, in_seed)
        position_bias = None
        for block, seeds in zip(self.blocks(), block_seeds):
            hidden, position_bias = block(
                hidden, mask, encoder_hidden, encoder_mask, position_bias,
                cache, cross_from_cache, seeds)
        if cache is not None:
            cache.advance(hidden.shape[1])
        return dropout(self.final_layer_norm(hidden), cfg.dropout_rate,
                       out_seed)


@torch.no_grad()
def init_t5_weights(model: nn.Module, generator: torch.Generator,
                    config: T5Config) -> None:
    """The reference's initialisers (HF T5's ``_init_weights``, which
    Fengshen's T5 classes inherit), in module order, with ``factor`` the
    config's ``initializer_factor``: the shared embedding and the untied
    head N(0, factor); q N(0, factor (d_model d_kv)^-0.5), k and v
    N(0, factor d_model^-0.5), o N(0, factor (heads d_kv)^-0.5), the
    relative-bias tables N(0, factor d_model^-0.5); wi (wi_0, wi_1)
    N(0, factor d_model^-0.5), wo N(0, factor d_ff^-0.5); norms at
    factor.

    The JAX package draws every projection from N(0, factor
    d_model^-0.5) (``modeling_t5.py:95-99``): q then gives scores of
    std sqrt(d_kv), and a random 24 + 24-layer model attends so
    sharply that bf16 rounding sends its logits elsewhere (bf16 against
    fp32 compute, relative L2 1.29 in the JAX package at 24 + 24 layers
    of width 256 on the CPU). Weights read from a checkpoint or from
    the JAX package are unaffected."""
    factor = config.initializer_factor
    d, kv, heads = config.d_model, config.d_kv, config.num_heads
    stds = {"q": (d * kv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5,
            "o": (heads * kv) ** -0.5, "wi": d ** -0.5, "wi_0": d ** -0.5,
            "wi_1": d ** -0.5, "wo": config.d_ff ** -0.5,
            "relative_attention_bias": d ** -0.5, "lm_head": 1.0,
            "shared": 1.0}
    for name, module in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(module, T5LayerNorm):
            module.weight.fill_(factor)
        elif isinstance(module, (nn.Linear, Embed, VocabParallelEmbed)):
            module.weight.normal_(0.0, factor * stds[leaf],
                                  generator=generator)


def _place(model: nn.Module, device, generator, init: bool,
           config: T5Config) -> None:
    """Allocate ``model`` (built on ``meta``) on ``device`` (None:
    ``cuda``, raising without a card) and, with ``init``, draw its
    weights from ``generator`` (default: seed 0 on the device)."""
    dev = resolve_device(device)
    model.to_empty(device=dev)
    if not init or dev.type == "meta":
        return
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    init_t5_weights(model, generator, config)


class T5Model(nn.Module):
    """The shared embedding and both stacks (:293); ``with_decoder=False``
    builds the encoder alone (what :class:`T5EncoderModel` runs).
    ``device=None`` means ``cuda`` and raises without a card; the
    weights are drawn there from ``generator`` (``init=False`` leaves
    them unwritten, for a loader)."""

    def __init__(self, config: T5Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True, with_decoder: bool = True):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.shared = VocabParallelEmbed(
                config.vocab_size, config.d_model,
                param_dtype=torch_dtype(config.param_dtype))
            self.encoder = T5Stack(config, causal=False)
            if with_decoder:
                self.decoder = T5Stack(config, causal=True)
        _place(self, device, generator, init, config)

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        dt = torch_dtype(self.config.dtype)
        return self.encoder(self.shared(input_ids, dt), mask=attention_mask,
                            deterministic=deterministic,
                            dropout_rng=dropout_rng)

    def decode(self, decoder_input_ids, encoder_hidden, attention_mask=None,
               decoder_attention_mask=None, cache=None,
               cross_from_cache: bool = False, deterministic: bool = True,
               dropout_rng=None):
        dt = torch_dtype(self.config.dtype)
        return self.decoder(self.shared(decoder_input_ids, dt),
                            mask=decoder_attention_mask,
                            encoder_hidden=encoder_hidden,
                            encoder_mask=attention_mask, cache=cache,
                            cross_from_cache=cross_from_cache,
                            deterministic=deterministic,
                            dropout_rng=dropout_rng)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng=None):
        """``(encoder output, decoder output)`` (:321)."""
        enc = self.encode(input_ids, attention_mask, deterministic,
                          dropout_rng)
        dec = self.decode(decoder_input_ids, enc, attention_mask,
                          decoder_attention_mask,
                          deterministic=deterministic,
                          dropout_rng=dropout_rng)
        return enc, dec


class T5ForConditionalGeneration(nn.Module):
    """:class:`T5Model` and the LM head (:331): tied to ``shared`` with
    the ``d_model ** -0.5`` rescale, or an untied ``lm_head``. Built and
    placed as :class:`T5Model` is."""

    def __init__(self, config: T5Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = T5Model(config, device="meta", init=False)
            if not config.tie_word_embeddings:
                self.lm_head = linear(config.d_model, config.vocab_size,
                                      config.param_dtype, bias=False)
        _place(self, device, generator, init, config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_t5_weights(self, generator, self.config)

    def _logits(self, dec: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.tie_word_embeddings:
            # HF rescales by d_model^-0.5 when tied
            dec = dec * (cfg.d_model ** -0.5)
            return dec @ self.model.shared.weight.to(dec.dtype).T
        return dense(self.lm_head, dec, torch_dtype(cfg.dtype))

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """``[B, T, V]`` logits in the compute dtype (:353)."""
        _, dec = self.model(input_ids, decoder_input_ids, attention_mask,
                            decoder_attention_mask, deterministic,
                            dropout_rng)
        return self._logits(dec)

    def encode(self, input_ids, attention_mask=None,
               deterministic: bool = True, dropout_rng=None):
        return self.model.encode(input_ids, attention_mask, deterministic,
                                 dropout_rng)

    def decode_logits(self, decoder_input_ids, encoder_hidden,
                      attention_mask=None,
                      cache: Optional[Seq2SeqCache] = None,
                      cross_from_cache: bool = False,
                      deterministic: bool = True, dropout_rng=None):
        """The decoder and the head over ``encoder_hidden`` (:364); with
        ``cache`` the decode step of ``utils/generate.py``."""
        dec = self.model.decode(decoder_input_ids, encoder_hidden,
                                attention_mask, None, cache,
                                cross_from_cache, deterministic,
                                dropout_rng)
        return self._logits(dec)

    def new_cache(self, rows: int, length: int) -> Seq2SeqCache:
        """An empty decoder cache of ``length`` positions for ``rows``
        rows, on the model's device in the compute dtype."""
        cfg = self.config
        return Seq2SeqCache.zeros(cfg.num_decoder_layers, rows, length,
                                  cfg.num_heads, cfg.d_kv, self.device,
                                  torch_dtype(cfg.dtype))

    @property
    def device(self) -> torch.device:
        return self.model.shared.weight.device


class T5EncoderModel(nn.Module):
    """The encoder alone, under the reference's ``model`` prefix
    (:376): ``model.shared`` and ``model.encoder``."""

    def __init__(self, config: T5Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = T5Model(config, device="meta", init=False,
                                 with_decoder=False)
        _place(self, device, generator, init, config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_t5_weights(self, generator, self.config)

    def forward(self, input_ids, attention_mask=None,
                deterministic: bool = True, dropout_rng=None):
        return self.model.encode(input_ids, attention_mask, deterministic,
                                 dropout_rng)
