"""T5 config: the port's own copy of
``fengshen_tpu/models/t5/configuration_t5.py``.

Field names and defaults are HF's (and the reference's), so a
``config.json`` written for one package loads in the other.
``is_gated_act`` and ``dense_act_fn`` split ``feed_forward_proj``
(``"relu"``, ``"gated-gelu"``); ``hidden_size``, ``num_hidden_layers``
(encoder plus decoder) and ``intermediate_size`` are the reference's
aliases. ``decode_cache_length`` bounds the cached decode of
``utils/generate.py`` (a decode of that many new tokens or more takes
the uncached path, as in the reference). ``gradient_checkpointing`` is
read by nothing, as in the reference: the T5 stack has no per-block
remat.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0
    feed_forward_proj: str = "relu"     # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    gradient_checkpointing: bool = False
    decode_cache_length: int = 512

    def __post_init__(self):
        if self.num_decoder_layers is None:
            self.num_decoder_layers = self.num_layers

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def dense_act_fn(self) -> str:
        return self.feed_forward_proj.split("-")[-1]

    @property
    def hidden_size(self) -> int:
        return self.d_model

    @property
    def num_hidden_layers(self) -> int:
        return self.num_layers + (self.num_decoder_layers or 0)

    @property
    def intermediate_size(self) -> int:
        return self.d_ff

    @classmethod
    def from_pretrained(cls, path: str) -> "T5Config":
        cfg_file = os.path.join(path, "config.json") if os.path.isdir(path) \
            else path
        with open(cfg_file) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self) | {"model_type": "t5"},
                      f, indent=2)

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "T5Config":
        base = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                    num_layers=2, num_heads=4)
        base.update(overrides)
        return cls(**base)
