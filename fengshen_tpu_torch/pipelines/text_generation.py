"""Text-generation pipeline: the port of
``fengshen_tpu/pipelines/text_generation.py:23``.

Either ``model`` names an HF LLaMA checkpoint directory (weights through
:func:`~fengshen_tpu_torch.models.llama.convert.load_hf_pretrained`, the
tokenizer through ``transformers.AutoTokenizer`` unless one is
injected), or ``module`` (and optionally ``params``) and ``tokenizer``
are injected. ``__call__`` is the one-request path (the ``simple``
engine: one batch-1 ``utils.generate.generate`` per call); the
continuous engine drives ``module`` through its pool, and this pipeline
supplies what it needs: ``module``, ``encode``/``decode`` and the
generation defaults (:meth:`engine_config_kwargs`).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np

from fengshen_tpu_torch.device import check_module_device


class IdTokenizer:
    """Token ids as text (``"5 7 9"`` <-> ``[5, 7, 9]``): a tokenizer
    for weights that have none (made from a seed, or a checkpoint
    written without one). Any other non-space character encodes as its
    code point, so prompt templates such as ``"<human>:"`` encode too."""

    eos_token_id = None
    pad_token_id = 0

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        del add_special_tokens  # no special tokens to add
        return [int(t) if t.isdecimal() else ord(t)
                for t in re.findall(r"\d+|\S", text)]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        del skip_special_tokens  # no special tokens to skip
        return " ".join(str(int(t)) for t in ids)


def auto_tokenizer(path: str):
    """``transformers.AutoTokenizer.from_pretrained(path)``, imported
    here only: the rest of the port never needs ``transformers``."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {path!r} needs the 'transformers' "
            "package, which is not installed; install it or pass a "
            "tokenizer") from e
    return AutoTokenizer.from_pretrained(path)


class Pipeline:
    """Causal-LM generation pipeline (LLaMA family).

    ``model`` is an HF checkpoint directory, or ``module`` a port model
    (its weights inside; ``params``, when given, is a state dict loaded
    into it). The tokenizer needs ``encode(text) -> list[int]`` /
    ``decode(ids) -> str`` plus ``eos_token_id``/``pad_token_id``
    attributes. ``seed`` is the sampling seed. ``device=None`` means
    ``cuda``; an injected module must live on the device. ``dtype`` and
    ``param_dtype``, when given, override the checkpoint config's."""

    task = "text_generation"

    def __init__(self, args: Any = None, model: Optional[str] = None,
                 module: Any = None, params: Any = None,
                 tokenizer: Any = None, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 min_length: int = 0, seed: int = 0, device=None,
                 dtype: Optional[str] = None,
                 param_dtype: Optional[str] = None):
        if args is not None:
            # the pipeline CLI parses add_pipeline_specific_args' flags
            max_new_tokens = getattr(args, "max_new_tokens", max_new_tokens)
            do_sample = getattr(args, "do_sample", do_sample)
            temperature = getattr(args, "temperature", temperature)
            top_k = getattr(args, "top_k", top_k)
            top_p = getattr(args, "top_p", top_p)
        if module is None:
            if model is None:
                raise ValueError(
                    "text_generation needs either model=<hf checkpoint "
                    "dir> or an injected module and tokenizer")
            import dataclasses

            from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                         load_hf_pretrained)
            config = LlamaConfig.from_pretrained(model)
            overrides = {k: v for k, v in (("dtype", dtype),
                                           ("param_dtype", param_dtype))
                         if v is not None}
            config = dataclasses.replace(config, **overrides)
            _, module = load_hf_pretrained(model, config, device=device)
            if tokenizer is None:
                tokenizer = auto_tokenizer(model)
        elif tokenizer is None:
            raise ValueError("an injected module needs a tokenizer")
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
        self._n_calls = 0

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

    # ---- the one-request path ---------------------------------------

    def __call__(self, input_text: str,
                 max_new_tokens: Optional[int] = None) -> str:
        ids = self.encode(input_text)
        out = self.generate_ids(ids, max_new_tokens or self.max_new_tokens)
        return self.decode(out)

    def generate_ids(self, ids: np.ndarray, max_new_tokens: int) -> list:
        """Batch-1 decode through ``utils.generate.generate`` (the
        ``simple`` engine; on the card its decode steps run K3). The
        call is the ``pipeline/generate`` span, and the global
        ``fstpu_pipeline_generated_tokens_total`` counts its real tokens
        (up to and including eos, not the pad after it). Call ``n`` of
        the pipeline samples under seed ``seed + n``, as the reference's
        ``PRNGKey(seed + n)``."""
        from fengshen_tpu_torch.observability import get_registry, span
        from fengshen_tpu_torch.utils.generate import generate
        self._n_calls += 1
        with span("pipeline/generate"):
            out = generate(
                self.module, np.asarray(ids, np.int64)[None],
                max_new_tokens=max_new_tokens,
                eos_token_id=self.eos_token_id,
                pad_token_id=self.pad_token_id,
                seed=self.seed + self._n_calls, device=self.device,
                **self.sample_kw)
        out = out[0, len(ids):].tolist()
        n_real = (out.index(self.eos_token_id) + 1
                  if self.eos_token_id is not None
                  and self.eos_token_id in out else len(out))
        get_registry().counter(
            "fstpu_pipeline_generated_tokens_total",
            "tokens generated by the legacy batch-1 pipeline path"
        ).inc(n_real)
        return out

    @staticmethod
    def add_pipeline_specific_args(parser):
        parser.add_argument("--max_new_tokens", default=64, type=int)
        parser.add_argument("--do_sample", action="store_true")
        parser.add_argument("--temperature", default=1.0, type=float)
        parser.add_argument("--top_k", default=0, type=int)
        parser.add_argument("--top_p", default=0.0, type=float)
        return parser
