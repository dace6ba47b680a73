"""GPT-2 in PyTorch: the port of ``fengshen_tpu/models/gpt2/modeling_gpt2.py``
(Wenzhong is an HF GPT-2 checkpoint).

Pre-LN blocks (:132-152): ``h + dropout(c_proj(attn(ln_1(h))))``, then
``h + dropout(c_proj(gelu_new(c_fc(ln_2(h)))))``. The attention (:56-95)
projects q, k and v with one fused ``c_attn`` (3 x n_embd) and runs the
dense attention of ``ops/attention.py`` (fp32 scores and softmax, the
mask as a -1e9 bias, dropout on the probabilities): the reference calls
``dot_product_attention`` without an ``impl``, so GPT-2 reaches no
kernel of the port there. The cacheless mask is causal ANDed with the
``[B, S]`` padding mask. Embeddings (:174-194): ``wte`` through
``VocabParallelEmbed`` plus ``wpe`` at ``position_ids`` (default
``arange``), then dropout; a final ``ln_f``. :class:`GPT2LMHeadModel`
ties the head to ``wte``: logits are ``hidden @ wte.T`` in the compute
dtype (:234), and :meth:`GPT2LMHeadModel.lm_head_kernel` gives the
``[H, V]`` view of ``wte`` that ``CausalLMModule``'s fused LM-head CE
(kernel K2) takes (:236-239).

Decode (``_update_cache``, :97-129) runs over the lockstep
``KVCache`` of ``models/llama`` with a scalar cursor: each layer writes
its step's K/V at the cursor in place, and every query attends densely
over all ``n_positions`` slots through a ``valid`` mask of
``slot <= q_pos`` ANDed with the padded ``attention_mask``. It never
goes to the decode-attention seam (kernel K3), as the reference never
goes to its Pallas kernel.

Compute runs in ``config.dtype`` over ``param_dtype`` parameters
(``models/layers.py``). With ``gradient_checkpointing`` every block is
recomputed in the backward (``torch.utils.checkpoint``, keeping only
its input: the reference's ``nothing_saveable``, :204-208). Dropout
draws per-site seeds from the ``dropout_rng`` host generator
(``ops/dropout.py``); ``deterministic=True`` turns it off. Parameter
names are the reference's flax paths (``transformer.h_{i}.attn.c_attn``
and so on, ``h_{i}`` whatever ``scan_layers`` says); ``convert.py``
maps HF checkpoints and the JAX package's trees onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fengshen_tpu_torch.models.gpt2.configuration_gpt2 import GPT2Config
from fengshen_tpu_torch.models.layers import (Embed, dense, init_weights,
                                              linear, place, torch_dtype)
from fengshen_tpu_torch.ops.activations import get_activation
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.dropout import (dropout, forward_seeds,
                                            site_generator)
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.masks import causal_mask
from fengshen_tpu_torch.ops.norms import LayerNorm

#: dropout sites per block: attention probabilities, attention output,
#: MLP output
BLOCK_SITES = 3


def decode_mask(cache, seq: int, attention_mask, device) -> torch.Tensor:
    """``[B, 1, S, L]`` validity of the cache's ``L`` slots for the
    ``S`` queries written at the cursor (:118-128): ``slot <= q_pos``,
    ANDed with the ``[B, S0]`` padding mask padded with ones to ``L``."""
    if cache.block_table is not None or cache.quantized or \
            isinstance(cache.index, torch.Tensor):
        raise ValueError("GPT-2 decodes over a lockstep cache with a "
                         "scalar cursor (KVCache.zeros), as the "
                         "reference's cache_index")
    batch, max_len = cache.keys[0].shape[:2]
    q_pos = cache.index + torch.arange(seq, device=device)
    valid = torch.arange(max_len, device=device)[None, :] <= q_pos[:, None]
    valid = valid[None].expand(batch, seq, max_len)
    if attention_mask is not None:
        full = F.pad(attention_mask.long(),
                     (0, max_len - attention_mask.shape[1]), value=1)
        valid = valid & full[:, None, :].bool()
    return valid[:, None]


class GPT2Attention(nn.Module):
    def __init__(self, config: GPT2Config, layer_idx: int):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        h, p = config.n_embd, config.param_dtype
        self.c_attn = linear(h, 3 * h, p)
        self.c_proj = linear(h, h, p)

    def forward(self, hidden, mask, cache=None, seeds=(None, None)):
        """``mask`` bool ``[B, 1, S, K]``; ``cache`` a lockstep
        ``KVCache`` (written in place at its cursor, then read whole);
        ``seeds`` the probabilities' and the output's dropout seeds."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        batch, seq, _ = hidden.shape
        shape = (batch, seq, cfg.n_head, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in dense(
            self.c_attn, hidden, dt).split(cfg.n_embd, dim=-1))
        if cache is not None:
            ck = cache.keys[self.layer_idx]
            cv = cache.values[self.layer_idx]
            # the write clamps its start as dynamic_update_slice does
            start = min(max(int(cache.index), 0), ck.shape[1] - seq)
            ck[:, start:start + seq] = k.to(ck.dtype)
            cv[:, start:start + seq] = v.to(cv.dtype)
            k, v = ck, cv
        s_probs, s_out = seeds
        out = dot_product_attention(
            q, k, v, mask=mask, dropout_rng=site_generator(s_probs,
                                                           q.device),
            dropout_rate=cfg.attn_pdrop, deterministic=s_probs is None)
        out = dense(self.c_proj, out.reshape(batch, seq, cfg.n_embd), dt)
        return dropout(out, cfg.resid_pdrop, s_out)


class GPT2Block(nn.Module):
    def __init__(self, config: GPT2Config, layer_idx: int):
        super().__init__()
        self.config = config
        h, p = config.n_embd, config.param_dtype
        self.ln_1 = LayerNorm(h, config.layer_norm_epsilon)
        self.attn = GPT2Attention(config, layer_idx)
        self.ln_2 = LayerNorm(h, config.layer_norm_epsilon)
        self.c_fc = linear(h, config.inner_dim, p)
        self.c_proj = linear(config.inner_dim, h, p)

    def forward(self, hidden, mask, cache=None, seeds=None):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        s_probs, s_attn, s_mlp = seeds or (None, None, None)
        hidden = hidden + self.attn(self.ln_1(hidden), mask, cache,
                                    (s_probs, s_attn))
        h = dense(self.c_fc, self.ln_2(hidden), dt)
        h = dense(self.c_proj, get_activation(cfg.activation_function)(h),
                  dt)
        return hidden + dropout(h, cfg.resid_pdrop, s_mlp)


class GPT2Model(nn.Module):
    """The decoder stack (:160). ``device=None`` means ``cuda`` and
    raises without a card; the weights are drawn there from
    ``generator`` (``init=False`` leaves them unwritten, for a
    loader)."""

    def __init__(self, config: GPT2Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        h, p = config.n_embd, config.param_dtype
        with torch.device("meta"):
            self.wte = VocabParallelEmbed(config.vocab_size, h,
                                          param_dtype=torch_dtype(p))
            self.wpe = Embed(config.n_positions, h, p)
            for i in range(config.n_layer):
                setattr(self, f"h_{i}", GPT2Block(config, i))
            self.ln_f = LayerNorm(h, config.layer_norm_epsilon)
        place(self, device, generator, init, config.initializer_range)

    def blocks(self) -> list:
        return [getattr(self, f"h_{i}") for i in range(self.config.n_layer)]

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None):
        """Final-LN hidden states ``[B, S, H]`` in the compute dtype.
        ``cache`` given = the decode path (the reference's
        ``init_cache=True``); its cursor advances by ``S``."""
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        seq = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(seq, device=dev)[None]
        embed_seed, block_seeds = forward_seeds(
            dropout_rng, cfg.n_layer, BLOCK_SITES, not deterministic and any(
                (cfg.embd_pdrop, cfg.attn_pdrop, cfg.resid_pdrop)))
        hidden = self.wte(input_ids, dt) + self.wpe(position_ids, dt)
        hidden = dropout(hidden, cfg.embd_pdrop, embed_seed)
        if cache is not None:
            mask = decode_mask(cache, seq, attention_mask, dev)
        else:
            mask = causal_mask(seq, seq, device=dev)[None, None]
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, None, :].bool()
        remat = cfg.gradient_checkpointing and cache is None and \
            torch.is_grad_enabled()
        for block, seeds in zip(self.blocks(), block_seeds):
            if remat:
                hidden = checkpoint(block, hidden, mask, None, seeds,
                                    use_reentrant=False)
            else:
                hidden = block(hidden, mask, cache, seeds)
        if cache is not None:
            cache.advance(seq)
        return self.ln_f(hidden)


class GPT2LMHeadModel(nn.Module):
    """The LM head tied to ``wte`` (HF ``GPT2LMHeadModel``, :217), built
    and placed as :class:`GPT2Model` is."""

    def __init__(self, config: GPT2Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.transformer = GPT2Model(config, device="meta", init=False)
        place(self, device, generator, init, config.initializer_range)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator, self.config.initializer_range)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None, deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None,
                return_hidden: bool = False):
        """``[B, S, V]`` logits in the compute dtype, or with
        ``return_hidden`` the final-LN hidden states (for the fused head
        + CE, which applies the tied head itself)."""
        hidden = self.transformer(input_ids, attention_mask, position_ids,
                                  cache, deterministic, dropout_rng)
        if return_hidden:
            return hidden
        return hidden @ self.transformer.wte.weight.to(hidden.dtype).T

    def lm_head_kernel(self) -> torch.Tensor:
        """The ``[H, V]`` head of the fused-CE path: ``wte`` transposed
        (a view; the gradient reaches ``wte`` through it)."""
        return self.transformer.wte.weight.T

    @property
    def device(self) -> torch.device:
        return self.transformer.ln_f.weight.device
