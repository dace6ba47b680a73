"""Text-generation pipeline: the port of
``fengshen_tpu/pipelines/text_generation.py:23`` with only its injected
``module``/``params``/``tokenizer`` path (loading a checkpoint directory
and the one-request ``__call__`` path are not yet ported).

The continuous engine drives ``module`` through its pool; this pipeline
supplies what it needs: ``module``, ``encode``/``decode`` and the
generation defaults (:meth:`engine_config_kwargs`).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.device import check_module_device


class IdTokenizer:
    """Token ids as text (``"5 7 9"`` <-> ``[5, 7, 9]``): the stand-in
    tokenizer while checkpoint tokenizers are not ported. Any other
    non-space character encodes as its code point, so prompt templates
    such as ``"<human>:"`` encode too."""

    eos_token_id = None
    pad_token_id = 0

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        del add_special_tokens  # no special tokens to add
        return [int(t) if t.isdecimal() else ord(t)
                for t in re.findall(r"\d+|\S", text)]

    def decode(self, ids) -> str:
        return " ".join(str(int(t)) for t in ids)


class Pipeline:
    """Causal-LM generation pipeline (LLaMA family).

    ``module`` is a port model (its weights inside); ``params``, when
    given, is a state dict loaded into it (for example from
    ``models.llama.convert.params_from_jax``). The tokenizer needs
    ``encode(text) -> list[int]`` / ``decode(ids) -> str`` plus
    ``eos_token_id``/``pad_token_id`` attributes. ``device=None`` means
    ``cuda``; the module must live on the device."""

    task = "text_generation"

    def __init__(self, module: Any, tokenizer: Any, params: Any = None,
                 max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 min_length: int = 0, seed: int = 0, device=None):
        self.device = check_module_device(module, device)
        if params is not None:
            module.load_state_dict(params)
        self.module = module
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id if eos_token_id is not None \
            else getattr(tokenizer, "eos_token_id", None)
        pad = pad_token_id if pad_token_id is not None \
            else getattr(tokenizer, "pad_token_id", None)
        self.pad_token_id = 0 if pad is None else int(pad)
        self.sample_kw = dict(do_sample=do_sample,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p,
                              repetition_penalty=repetition_penalty,
                              min_length=min_length)
        self.seed = seed

    # ---- engine integration -----------------------------------------

    def encode(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    def decode(self, token_ids) -> str:
        ids = [int(t) for t in token_ids]
        if self.eos_token_id is not None and self.eos_token_id in ids:
            ids = ids[:ids.index(self.eos_token_id)]
        return self.tokenizer.decode(ids)

    def engine_config_kwargs(self) -> dict:
        """Generation defaults for ``serving.EngineConfig(**...)``."""
        return dict(max_new_tokens=self.max_new_tokens,
                    eos_token_id=self.eos_token_id,
                    pad_token_id=self.pad_token_id, seed=self.seed,
                    **self.sample_kw)
