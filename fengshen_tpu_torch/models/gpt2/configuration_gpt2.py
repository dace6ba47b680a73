"""GPT-2 config: the port's own copy of
``fengshen_tpu/models/gpt2/configuration_gpt2.py``.

Field names and defaults are HF's (and the reference's), so a
``config.json`` written for one package loads in the other. The aliases
``hidden_size``, ``num_hidden_layers``, ``intermediate_size`` and
``max_position_embeddings`` are the reference's; ``num_attention_heads``
and ``num_key_value_heads`` (both ``n_head``) are the port's, so that
the lockstep ``KVCache.zeros`` of ``models/llama`` and the decode loop
of ``utils/generate.py`` build GPT-2's cache unchanged. ``scan_layers``
is the layout of the JAX parameter tree (``h`` stacked on ``[L]``, or
``h_{i}``) that :func:`..convert.params_from_jax` reads; the port's
modules are always ``h_{i}``. ``attention_impl`` is read by nothing, as
in the reference: GPT-2's attention is always dense.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None          # default 4 * n_embd
    activation_function: str = "gelu_new"
    resid_pdrop: float = 0.1
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    #: > 0: the fused LM-head + CE through kernel K2 in CausalLMModule
    fused_ce_chunks: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    gradient_checkpointing: bool = False
    scan_layers: bool = False
    attention_impl: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def inner_dim(self) -> int:
        return self.n_inner or 4 * self.n_embd

    @property
    def hidden_size(self) -> int:
        return self.n_embd

    @property
    def num_hidden_layers(self) -> int:
        return self.n_layer

    @property
    def num_attention_heads(self) -> int:
        return self.n_head

    @property
    def num_key_value_heads(self) -> int:
        return self.n_head

    @property
    def intermediate_size(self) -> int:
        return self.inner_dim

    @property
    def max_position_embeddings(self) -> int:
        return self.n_positions

    @classmethod
    def from_pretrained(cls, path: str) -> "GPT2Config":
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
                      {"model_type": "gpt2"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "GPT2Config":
        base = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                    n_head=4)
        base.update(overrides)
        return cls(**base)
