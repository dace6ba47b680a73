"""MegatronBert config: the port's own copy of
``fengshen_tpu/models/megatron_bert/configuration_megatron_bert.py``.

Field names and defaults are the reference's (HF's), so a ``config.json``
written for one package loads in the other. ``scan_layers`` has no
meaning in eager PyTorch, but it is the layout of the JAX parameter tree
(``layer`` stacked on ``[L]``, or ``layer_{i}``) that
:func:`..convert.params_from_jax` reads, so it is kept; the port's
modules are always ``layer_{i}``. ``dtype`` is the compute dtype and
``param_dtype`` the dtype of the projections and embeddings (layer
norms are fp32 whatever it is), as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class MegatronBertConfig:
    vocab_size: int = 29056
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    num_labels: int = 2
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    gradient_checkpointing: bool = False
    scan_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_pretrained(cls, path: str) -> "MegatronBertConfig":
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
                      {"model_type": "megatron-bert"}, f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "MegatronBertConfig":
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64)
        base.update(overrides)
        return cls(**base)
