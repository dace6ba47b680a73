"""Lazy auto registry of the port's model families: the port of
``fengshen_tpu/models/auto/auto_factory.py``.

``MODEL_REGISTRY`` maps a ``model_type`` (read from ``config.json``'s
``fengshen_model_type`` or ``model_type``, :117-122) to the family's
module, config class and heads, imported on first use (:14-101). The
families the port has are registered with their heads: ``llama``,
``ziya_llama``, ``gpt2``, ``megatron-bert``, ``bert``, ``deberta-v2``,
``t5``, ``bart``, ``pegasus`` and ``deltalm``. A family the
JAX package registers and the port does not have yet raises
``NotImplementedError`` naming ROADMAP.md queue 1 item 11; an unknown
``model_type`` raises ``KeyError``, as the reference does.

:meth:`AutoModel.from_config` builds the head's model from a config,
passing its keyword arguments on (``device="cpu"``, ``generator``,
``init``: the port's models hold their weights and are made on the
card unless asked otherwise). Loading weights stays with each family's
``convert.load_hf_pretrained`` (the reference's
``AutoModel.from_pretrained`` is not ported). :class:`AutoTokenizer`
resolves the char-level Randeng T5 tokenizers (``megatron_t5``,
``t5_char``) to ``models/t5``'s ``T5Tokenizer`` and defers the rest to
``transformers``, imported there only.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any

#: model_type -> (module, config class, {head: model class}); names
#: only, imported lazily like the reference's _LazyAutoMapping
MODEL_REGISTRY: dict[str, tuple[str, str, dict[str, str]]] = {
    "llama": ("fengshen_tpu_torch.models.llama", "LlamaConfig",
              {"causal_lm": "LlamaForCausalLM", "base": "LlamaModel"}),
    "ziya_llama": ("fengshen_tpu_torch.models.llama", "LlamaConfig",
                   {"causal_lm": "LlamaForCausalLM"}),
    "gpt2": ("fengshen_tpu_torch.models.gpt2", "GPT2Config",
             {"causal_lm": "GPT2LMHeadModel", "base": "GPT2Model"}),
    "megatron-bert": ("fengshen_tpu_torch.models.megatron_bert",
                      "MegatronBertConfig",
                      {"base": "MegatronBertModel",
                       "pretraining": "MegatronBertForPreTraining",
                       "masked_lm": "MegatronBertForMaskedLM",
                       "sequence_classification":
                           "MegatronBertForSequenceClassification",
                       "token_classification":
                           "MegatronBertForTokenClassification"}),
    "bert": ("fengshen_tpu_torch.models.bert", "BertConfig",
             {"base": "BertModel", "masked_lm": "BertForMaskedLM"}),
    "deberta-v2": ("fengshen_tpu_torch.models.deberta_v2", "DebertaV2Config",
                   {"base": "DebertaV2Model",
                    "masked_lm": "DebertaV2ForMaskedLM",
                    "sequence_classification":
                        "DebertaV2ForSequenceClassification"}),
    "t5": ("fengshen_tpu_torch.models.t5", "T5Config",
           {"base": "T5Model",
            "conditional_generation": "T5ForConditionalGeneration",
            "encoder": "T5EncoderModel"}),
    "bart": ("fengshen_tpu_torch.models.bart", "BartConfig",
             {"base": "BartModel",
              "conditional_generation": "BartForConditionalGeneration"}),
    "pegasus": ("fengshen_tpu_torch.models.pegasus", "PegasusConfig",
                {"conditional_generation":
                     "PegasusForConditionalGeneration"}),
    "deltalm": ("fengshen_tpu_torch.models.deltalm", "DeltaLMConfig",
                {"conditional_generation":
                     "DeltaLMForConditionalGeneration"}),
}

#: the JAX package's registered families the port does not have yet
NOT_YET_PORTED = (
    "roformer", "albert", "longformer", "zen", "zen2",
    "davae", "gavae", "ppvae",
    "della", "transfo-xl-denoise", "transfo-xl-paraphrase",
    "transfo-xl-reasoning")

#: model_type -> (module, factory) of the tokenizers transformers'
#: AutoTokenizer cannot resolve (:193-198): the char-level Randeng T5
TOKENIZER_REGISTRY: dict[str, tuple[str, str]] = {
    "megatron_t5": ("fengshen_tpu_torch.models.t5", "T5Tokenizer"),
    "t5_char": ("fengshen_tpu_torch.models.t5", "T5Tokenizer"),
}


def register_model(model_type: str, module: str, config_cls: str,
                   heads: dict[str, str]) -> None:
    """Extend the registry (the reference's trust-remote-code loader
    role)."""
    MODEL_REGISTRY[model_type] = (module, config_cls, heads)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported in fengshen_tpu_torch (ROADMAP.md "
        "queue 1 item 11: the rest of the zoo)")


def _resolve(model_type: str):
    if model_type not in MODEL_REGISTRY:
        if model_type in NOT_YET_PORTED:
            raise _not_ported(f"model_type {model_type!r}")
        raise KeyError(f"unknown model_type {model_type!r}; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    module_name, config_name, heads = MODEL_REGISTRY[model_type]
    return importlib.import_module(module_name), config_name, heads


def _read_config(path: str) -> dict:
    cfg_file = os.path.join(path, "config.json") if os.path.isdir(path) \
        else path
    with open(cfg_file) as f:
        return json.load(f)


def model_type_of(path: str) -> str:
    """``fengshen_model_type``, else ``model_type``, of a checkpoint
    directory's (or a file's) config."""
    raw = _read_config(path)
    return raw.get("fengshen_model_type", raw.get("model_type", ""))


class AutoConfig:
    @staticmethod
    def from_pretrained(path: str, **kwargs) -> Any:
        module, config_name, _ = _resolve(model_type_of(path))
        return getattr(module, config_name).from_pretrained(path)

    @staticmethod
    def for_model(model_type: str, **kwargs) -> Any:
        module, config_name, _ = _resolve(model_type)
        return getattr(module, config_name)(**kwargs)


class AutoModel:
    @staticmethod
    def from_config(config: Any, head: str = "base", **kwargs) -> Any:
        """The registered ``head`` model of ``config``'s family, built
        with ``kwargs`` (``device``, ``generator``, ``init`` where the
        class takes them)."""
        for module_name, config_name, heads in MODEL_REGISTRY.values():
            if type(config).__name__ == config_name and head in heads:
                module = importlib.import_module(module_name)
                return getattr(module, heads[head])(config, **kwargs)
        raise KeyError(
            f"no registered model for config {type(config).__name__} "
            f"with head {head!r}")


class AutoTokenizer:
    """The tokenizer of a checkpoint directory: the reference's own T5
    tokenizer when ``config.json`` names ``megatron_t5`` or ``t5_char``
    (``tokenizer_class``, ``fengshen_model_type`` or ``model_type``,
    :201-225), else ``transformers.AutoTokenizer``."""

    @staticmethod
    def from_pretrained(path: str, **kwargs) -> Any:
        cfg_file = os.path.join(path, "config.json") \
            if os.path.isdir(path) else None
        if cfg_file and os.path.exists(cfg_file):
            raw = _read_config(cfg_file)
            for key in ("tokenizer_class", "fengshen_model_type",
                        "model_type"):
                if raw.get(key, "") in TOKENIZER_REGISTRY:
                    module_name, attr = TOKENIZER_REGISTRY[raw[key]]
                    factory = getattr(importlib.import_module(module_name),
                                      attr)
                    return factory.from_pretrained(path, **kwargs)
        import transformers
        return transformers.AutoTokenizer.from_pretrained(path, **kwargs)
