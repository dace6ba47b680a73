"""LLaMA config: the port's own copy of
``fengshen_tpu/models/llama/configuration_llama.py:15 LlamaConfig``.

Field names and defaults are the reference's, so a config.json written
for one package loads in the other. Knobs that only steer TPU code
(``scan_layers``, ``gradient_checkpointing``, ``remat_policy``) are kept
so such files load unchanged; in the port ``scan_layers`` is only a
parameter layout that :func:`..convert.params_from_jax` reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None = MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    use_cache: bool = True
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    gradient_checkpointing: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "dense"      # dense | flash | ring | ulysses | sequence
    int8_lm_head: bool = False
    fused_ce_chunks: int = 0
    scan_layers: bool = False
    multiple_of: int = 256
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    packed_sequences: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_pretrained(cls, path: str) -> "LlamaConfig":
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
                      {"model_type": "llama"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128, multiple_of=16)
        base.update(overrides)
        return cls(**base)
