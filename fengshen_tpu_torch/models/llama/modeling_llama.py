"""LLaMA in PyTorch: the port of ``fengshen_tpu/models/llama/modeling_llama.py``.

RMSNorm pre-norm, rotary, SwiGLU, causal LM head and KV-cached decode.
Parameter names follow the HF ``LlamaForCausalLM`` layout, which is what
the JAX package's ``convert.py:68 params_to_torch_state`` maps its flax
tree to; :func:`.convert.params_from_jax` produces this state dict.

The decode cache is an explicit :class:`KVCache` object that replaces
flax's mutable ``"cache"`` collection. Each attention layer WRITES its
step's K/V into the cache IN PLACE and reads the cache through the
decode-attention seam; :class:`LlamaModel` advances the cursor once
after the layer loop (every layer of the reference kept its own cursor,
all equal). Three layouts share the entry point, as in the reference's
``_update_cache``:

- a scalar (Python int) ``index``: lockstep batch decode (``utils.generate``);
- a ``[B]`` index tensor: the serving slot pool, every lane at its own
  position;
- a ``block_table``: the paged pool, lanes indirect through per-slot
  block lists into a shared block pool.

The layers run as a plain loop over ``model.layers`` (the reference's
``scan_layers`` is only a parameter layout here). The cacheless forward
takes ``attention_impl`` "dense" or "flash" (kernel K1 through
``ops/flash_attention.py``); with ``gradient_checkpointing`` every layer
is recomputed in the backward (``torch.utils.checkpoint``), the
reference's remat policy "nothing".
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.llama.configuration_llama import LlamaConfig
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.embedding import embed_lookup
from fengshen_tpu_torch.ops.flash_attention import flash_attention
from fengshen_tpu_torch.ops.kernels.decode_attention import decode_attention
from fengshen_tpu_torch.ops.masks import causal_mask
from fengshen_tpu_torch.ops.norms import RMSNorm
from fengshen_tpu_torch.ops.rotary import apply_rotary_pos_emb


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` and so on."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class KVCache:
    """Decode cache shared by every layer of one model.

    ``keys``/``values`` hold one tensor per layer: ``[B, L, KVH, D]`` for
    the lockstep and slot layouts, ``[num_blocks, block_size, KVH, D]``
    for the paged pool (with ``block_table [B, max_blocks]`` int32).
    ``index`` is the write cursor: a Python int for lockstep decode, a
    ``[B]`` int64 tensor for the serving pools. Attention layers update
    the tensors in place."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor],
                 index: Union[int, torch.Tensor],
                 block_table: Optional[torch.Tensor] = None):
        self.keys = keys
        self.values = values
        self.index = index
        self.block_table = block_table

    @classmethod
    def zeros(cls, config: LlamaConfig, batch: int, max_len: int,
              device, dtype: torch.dtype) -> "KVCache":
        """A lockstep cache with a scalar cursor at 0."""
        shape = (batch, max_len, config.num_key_value_heads,
                 config.head_dim)
        n = config.num_hidden_layers
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)],
                   [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)], 0)

    def advance(self, seq: int) -> None:
        self.index = self.index + seq


class CacheView(NamedTuple):
    """What :meth:`LlamaAttention._update_cache` hands the decode seam:
    the cache in its native layout (the paged pool stays behind its
    block table) plus the ``[B, Sq, L]`` validity over the lane."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    block_table: Optional[torch.Tensor]
    valid: torch.Tensor


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=...)``: inputs and kernel both cast to the
    compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _proj(config: LlamaConfig, n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False,
                     dtype=torch_dtype(config.param_dtype))


class LlamaMLP(nn.Module):
    """SwiGLU (``modeling_llama.py:97``)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        inter = config.intermediate_size
        if inter is None:
            inter = int(2 * 4 * config.hidden_size / 3)
            inter = config.multiple_of * (
                (inter + config.multiple_of - 1) // config.multiple_of)
        self.gate_proj = _proj(config, config.hidden_size, inter)
        self.up_proj = _proj(config, config.hidden_size, inter)
        self.down_proj = _proj(config, inter, config.hidden_size)

    def forward(self, x):
        dt = torch_dtype(self.config.dtype)
        h = F.silu(_linear(self.gate_proj, x, dt)) * \
            _linear(self.up_proj, x, dt)
        return _linear(self.down_proj, h, dt)


class LlamaAttention(nn.Module):
    """Rotary MHA/GQA with the KV cache (``modeling_llama.py:124``)."""

    def __init__(self, config: LlamaConfig, layer_idx: int):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        h, kv, hd = (config.num_attention_heads,
                     config.num_key_value_heads, config.head_dim)
        self.q_proj = _proj(config, config.hidden_size, h * hd)
        self.k_proj = _proj(config, config.hidden_size, kv * hd)
        self.v_proj = _proj(config, config.hidden_size, kv * hd)
        self.o_proj = _proj(config, h * hd, config.hidden_size)

    def forward(self, hidden, attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        n_heads, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
        head_dim = cfg.head_dim
        batch, seq, _ = hidden.shape
        q = _linear(self.q_proj, hidden, dt).view(batch, seq, n_heads,
                                                  head_dim)
        k = _linear(self.k_proj, hidden, dt).view(batch, seq, n_kv, head_dim)
        v = _linear(self.v_proj, hidden, dt).view(batch, seq, n_kv, head_dim)
        if position_ids is None:
            position_ids = torch.arange(seq, device=hidden.device)[None]
        q, k = apply_rotary_pos_emb(q, k, position_ids, base=cfg.rope_theta)

        if cache is not None:
            # every decode layout routes through ONE seam: the CUDA kernel
            # reads the paged pool through the block table with no gather
            # copy; the plain version gathers (ops/kernels/decode_attention)
            view = self._update_cache(k, v, attention_mask, cache)
            out = decode_attention(q, view.k, view.v, view.valid,
                                   block_table=view.block_table)
        else:
            if cfg.attention_impl not in ("dense", "flash"):
                raise NotImplementedError(
                    f"attention_impl={cfg.attention_impl!r} is not yet "
                    "ported; the cacheless forward supports 'dense' and "
                    "'flash'")
            if cfg.packed_sequences:
                raise NotImplementedError(
                    "packed_sequences is not yet ported")
            if cfg.attention_impl == "flash":
                # a padding mask maps to segment ids (pads = segment 0),
                # so padded SFT batches stay on kernel K1, which reads
                # each KV head once per GQA group
                seg = None if attention_mask is None else \
                    attention_mask.to(torch.int32)
                out = flash_attention(q, k, v, causal=True, segment_ids=seg)
            else:
                mask = causal_mask(seq, seq, device=hidden.device)[None, None]
                if attention_mask is not None:
                    mask = mask & attention_mask[:, None, None, :].bool()
                if n_kv != n_heads:
                    rep = n_heads // n_kv
                    k = k.repeat_interleave(rep, dim=2)
                    v = v.repeat_interleave(rep, dim=2)
                out = dot_product_attention(q, k, v, mask=mask)
        out = out.reshape(batch, seq, n_heads * head_dim)
        return _linear(self.o_proj, out, dt)

    def _update_cache(self, k, v, attention_mask,
                      cache: KVCache) -> CacheView:
        """Write this step's K/V at the cursor (in place) and return the
        cache's view for the attention read (``modeling_llama.py:212``)."""
        if cache.block_table is not None:
            return self._update_paged_cache(k, v, attention_mask, cache)
        batch, seq = k.shape[:2]
        ck, cv = cache.keys[self.layer_idx], cache.values[self.layer_idx]
        max_len = ck.shape[1]
        dev = k.device
        steps = torch.arange(seq, device=dev)
        idx = cache.index
        if isinstance(idx, torch.Tensor):
            # slot-pool decode: a [B] cursor gives every lane its own
            # write position. The start clamps so the window fits the
            # lane, as the reference's dynamic_update_slice does.
            start = idx.clamp(0, max_len - seq)
            lanes = torch.arange(batch, device=dev)[:, None]
            pos = start[:, None] + steps[None]
            ck[lanes, pos] = k.to(ck.dtype)
            cv[lanes, pos] = v.to(cv.dtype)
            q_pos = idx[:, None] + steps[None]                  # [B, S]
            valid = torch.arange(max_len, device=dev)[None, None] <= \
                q_pos[:, :, None]
        else:
            start = min(max(int(idx), 0), max_len - seq)
            ck[:, start:start + seq] = k.to(ck.dtype)
            cv[:, start:start + seq] = v.to(cv.dtype)
            q_pos = idx + steps
            valid = torch.arange(max_len, device=dev)[None, :] <= \
                q_pos[:, None]
            valid = valid[None].expand(batch, seq, max_len)
        if attention_mask is not None:
            # left-padded prompts: pad positions stay masked
            full = F.pad(attention_mask.long(),
                         (0, max_len - attention_mask.shape[1]), value=1)
            valid = valid & full[:, None, :].bool()
        return CacheView(ck, cv, None, None, None, valid.contiguous())

    def _update_paged_cache(self, k, v, attention_mask,
                            cache: KVCache) -> CacheView:
        """Paged decode (``modeling_llama.py:310``): scatter the step's
        K/V at ``table[lane, p // bs] * bs + p % bs`` for each position
        ``p = idx + 0..seq-1`` (a window may cross a block boundary).
        Inactive lanes are parked on block 0, the null block, which
        absorbs their writes and is never read unmasked."""
        batch, seq, n_kv, head_dim = k.shape
        pool_k = cache.keys[self.layer_idx]
        pool_v = cache.values[self.layer_idx]
        table = cache.block_table
        num_blocks, block_size = pool_k.shape[:2]
        max_blocks = table.shape[-1]
        virt_len = max_blocks * block_size
        if seq > virt_len:
            raise ValueError(
                f"paged cache updates take at most the virtual lane "
                f"length {virt_len} tokens per step (decode tick or "
                f"speculative verify window); got seq={seq}. Prefill "
                "runs on a contiguous batch-1 cache.")
        dev = k.device
        idx = cache.index                                      # [B]
        p = idx[:, None] + torch.arange(seq, device=dev)[None]  # [B, S]
        blk = torch.gather(table.long(), 1,
                           (p // block_size).clamp(0, max_blocks - 1))
        pos = (blk * block_size + p % block_size).reshape(-1)
        flat_k = pool_k.view(num_blocks * block_size, n_kv, head_dim)
        flat_v = pool_v.view(num_blocks * block_size, n_kv, head_dim)
        flat_k[pos] = k.reshape(batch * seq, n_kv, head_dim).to(flat_k.dtype)
        flat_v[pos] = v.reshape(batch * seq, n_kv, head_dim).to(flat_v.dtype)
        valid = torch.arange(virt_len, device=dev)[None, None] <= \
            p[:, :, None]
        if attention_mask is not None:
            m = attention_mask[:, :virt_len].long()
            if m.shape[1] < virt_len:
                m = F.pad(m, (0, virt_len - m.shape[1]), value=1)
            valid = valid & m[:, None, :].bool()
        return CacheView(pool_k, pool_v, None, None, table,
                         valid.contiguous())


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, layer_idx: int):
        super().__init__()
        if config.moe_experts > 0:
            raise NotImplementedError("MoE layers are not yet ported")
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.self_attn = LlamaAttention(config, layer_idx)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)
        self.mlp = LlamaMLP(config)

    def forward(self, hidden, attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None):
        h = self.self_attn(self.input_layernorm(hidden), attention_mask,
                           position_ids, cache)
        hidden = hidden + h
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class Embed(nn.Module):
    """Token embedding table ``weight [V, H]`` (``embed_lookup``)."""

    def __init__(self, num_embeddings: int, features: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               dtype=dtype))

    def forward(self, ids, dtype):
        return embed_lookup(self.weight.to(dtype), ids)


class LlamaModel(nn.Module):
    """Decoder stack (``modeling_llama.py:479``) as a layer loop."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        if config.gradient_checkpointing and \
                config.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy={config.remat_policy!r} is not yet ported; "
                "gradient checkpointing recomputes whole layers "
                "(remat_policy='nothing')")
        self.config = config
        self.embed_tokens = Embed(config.vocab_size, config.hidden_size,
                                  torch_dtype(config.param_dtype))
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, i)
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None):
        hidden = self.embed_tokens(input_ids, torch_dtype(self.config.dtype))
        remat = self.config.gradient_checkpointing and cache is None and \
            torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                # remat_policy "nothing": keep each layer's input only and
                # recompute the layer in the backward (nn.remat with
                # nothing_saveable in the reference)
                hidden = checkpoint(layer, hidden, attention_mask,
                                    position_ids, use_reentrant=False)
            else:
                hidden = layer(hidden, attention_mask, position_ids, cache)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """LM head on the stack (``modeling_llama.py:551``).

    The weights are made on ``device`` directly in ``param_dtype`` from
    ``generator`` (N(0, initializer_range), norms at 1), with no copy in
    any other dtype; load real weights with ``load_state_dict``
    (:func:`.convert.params_from_jax`). ``device=None`` means ``cuda``
    and raises without a card."""

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.int8_lm_head:
            raise NotImplementedError("int8_lm_head is not yet ported")
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.model = LlamaModel(config)
            self.lm_head = None if config.tie_word_embeddings else _proj(
                config, config.hidden_size, config.vocab_size)
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, (nn.Linear, Embed)):
                module.weight.normal_(0.0, std, generator=generator)
            elif isinstance(module, RMSNorm):
                module.weight.fill_(1.0)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None):
        """``cache`` given = the decode path (the reference's
        ``init_cache=True`` / existing cache); None = cacheless forward.
        Returns ``[B, S, V]`` logits in the compute dtype."""
        hidden = self.model(input_ids, attention_mask, position_ids, cache)
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.to(hidden.dtype).T
        return _linear(self.lm_head, hidden, hidden.dtype)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device
