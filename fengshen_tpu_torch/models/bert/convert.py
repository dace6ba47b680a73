"""Weights into and out of the port's BERT (the port of
``fengshen_tpu/models/bert/convert.py``).

:func:`torch_to_params` maps an HF BERT state dict (``bert.embeddings.
LayerNorm``, ``bert.encoder.layer.N.attention.self.query``, ...,
``cls.predictions.transform``) onto the port's names, as the reference's
``bert_layer`` helper does (``fengshen_tpu/utils/convert_common.py:41``).
:func:`params_to_torch_state` is the inverse, written out (the
reference derives it from the import against a template checkpoint);
the MLM decoder is written tied to the word embeddings, as HF saves it.
:func:`params_from_jax` reads the JAX package's flax tree.
"""

from __future__ import annotations

from typing import Any, Mapping

from fengshen_tpu_torch.models.bert.modeling_bert import BertConfig
from fengshen_tpu_torch.utils.convert_common import flax_to_state

#: the port's names in a layer -> HF's, under ``bert.encoder.layer.N.``
_LAYER_NAMES = {
    "query": "attention.self.query",
    "key": "attention.self.key",
    "value": "attention.self.value",
    "attention_output_dense": "attention.output.dense",
    "attention_ln": "attention.output.LayerNorm",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
    "output_ln": "output.LayerNorm",
}
_MLM_NAMES = {
    "transform_dense.weight": "cls.predictions.transform.dense.weight",
    "transform_dense.bias": "cls.predictions.transform.dense.bias",
    "transform_ln.weight": "cls.predictions.transform.LayerNorm.weight",
    "transform_ln.bias": "cls.predictions.transform.LayerNorm.bias",
    "bias": "cls.predictions.bias",
}


def _encoder_names(config: BertConfig) -> dict:
    """``{port name under bert.: HF name}``, pooler included."""
    names = {f"{e}_embeddings.weight": f"bert.embeddings.{e}_embeddings."
             f"weight" for e in ("word", "position", "token_type")}
    for leaf in ("weight", "bias"):
        names[f"embeddings_ln.{leaf}"] = f"bert.embeddings.LayerNorm.{leaf}"
        for i in range(config.num_hidden_layers):
            for port, hf in _LAYER_NAMES.items():
                names[f"layer_{i}.{port}.{leaf}"] = \
                    f"bert.encoder.layer.{i}.{hf}.{leaf}"
        names[f"pooler.{leaf}"] = f"bert.pooler.dense.{leaf}"
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: BertConfig) -> dict:
    """An HF ``Bert*`` state dict -> the port's state dict (encoder
    under ``bert.``; the pooler and the MLM head when the checkpoint has
    them). A missing encoder tensor raises ``KeyError``."""
    out = {}
    for port, hf in _encoder_names(config).items():
        if port.startswith("pooler.") and hf not in state_dict:
            continue
        out[f"bert.{port}"] = state_dict[hf]
    if all(hf in state_dict for hf in _MLM_NAMES.values()):
        out.update({port: state_dict[hf] for port, hf in _MLM_NAMES.items()})
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: BertConfig) -> dict:
    """The port's state dict (encoder under ``bert.``; the MLM head if
    present) -> an HF ``Bert*`` state dict."""
    out = {hf: state_dict[f"bert.{port}"]
           for port, hf in _encoder_names(config).items()
           if f"bert.{port}" in state_dict}
    out.update({hf: state_dict[port] for port, hf in _MLM_NAMES.items()
                if port in state_dict})
    if "cls.predictions.bias" in out:
        out["cls.predictions.decoder.weight"] = \
            out["bert.embeddings.word_embeddings.weight"]
        out["cls.predictions.decoder.bias"] = out["cls.predictions.bias"]
    return out


def params_from_jax(params: Mapping, config: BertConfig) -> dict:
    """The JAX package's flax param tree of a BERT module -> the port's
    state dict of fp32 tensors."""
    del config
    return flax_to_state(params)
