"""Weights into and out of the port's DeBERTa-v2 (the port of
``fengshen_tpu/models/deberta_v2/convert.py``).

- :func:`torch_to_params` (:15): an HF ``DebertaV2*`` state dict
  (``deberta.embeddings.*``, ``deberta.encoder.rel_embeddings``,
  ``deberta.encoder.layer.N.attention.self.query_proj``, ...) -> the
  port's state dict (the encoder under ``deberta.``), with the MLM head
  (``cls.predictions``) and the classification head (``pooler.dense``,
  ``classifier``) when the checkpoint has them. HF's ``[out, in]``
  weights and ``Conv1d`` kernels are the port's layout, so the map
  renames.
- :func:`params_to_torch_state`: the inverse, the MLM decoder written
  tied to the word embeddings as HF saves it.
- :func:`params_from_jax`: the JAX package's flax tree -> the port's
  state dict.
"""

from __future__ import annotations

from typing import Any, Mapping

from fengshen_tpu_torch.models.deberta_v2.modeling_deberta_v2 import (
    DebertaV2Config)
from fengshen_tpu_torch.utils.convert_common import flax_to_state, tensor

#: the port's names in a layer -> HF's, under ``deberta.encoder.layer.N.``
_LAYER_NAMES = {
    "self.query_proj": "attention.self.query_proj",
    "self.key_proj": "attention.self.key_proj",
    "self.value_proj": "attention.self.value_proj",
    "attention_output_dense": "attention.output.dense",
    "attention_ln": "attention.output.LayerNorm",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
    "output_ln": "output.LayerNorm",
}
_POS_PROJ_NAMES = {"self.pos_query_proj": "attention.self.pos_query_proj",
                   "self.pos_key_proj": "attention.self.pos_key_proj"}
#: head names: the port's -> HF's
_MLM_NAMES = {
    "transform_dense.weight": "cls.predictions.transform.dense.weight",
    "transform_dense.bias": "cls.predictions.transform.dense.bias",
    "transform_ln.weight": "cls.predictions.transform.LayerNorm.weight",
    "transform_ln.bias": "cls.predictions.transform.LayerNorm.bias",
    "bias": "cls.predictions.bias",
}
_CLS_NAMES = {"pooler_dense.weight": "pooler.dense.weight",
              "pooler_dense.bias": "pooler.dense.bias",
              "classifier.weight": "classifier.weight",
              "classifier.bias": "classifier.bias"}


def _encoder_names(config: DebertaV2Config) -> dict:
    """``{port name under deberta.: HF name}`` of the encoder."""
    names = {"word_embeddings.weight":
             "deberta.embeddings.word_embeddings.weight"}
    if config.position_biased_input:
        names["position_embeddings.weight"] = \
            "deberta.embeddings.position_embeddings.weight"
    if config.relative_attention:
        names["rel_embeddings"] = "deberta.encoder.rel_embeddings.weight"
    layer_names = dict(_LAYER_NAMES)
    if config.relative_attention and not config.share_att_key:
        layer_names.update(_POS_PROJ_NAMES)
    for leaf in ("weight", "bias"):
        names[f"embeddings_ln.{leaf}"] = \
            f"deberta.embeddings.LayerNorm.{leaf}"
        if config.relative_attention and "layer_norm" in config.norm_rel_ebd:
            names[f"rel_embeddings_ln.{leaf}"] = \
                f"deberta.encoder.LayerNorm.{leaf}"
        if config.conv_kernel_size > 0:
            names[f"conv.{leaf}"] = f"deberta.encoder.conv.conv.{leaf}"
            names[f"conv_ln.{leaf}"] = f"deberta.encoder.conv.LayerNorm.{leaf}"
        for i in range(config.num_hidden_layers):
            for port, hf in layer_names.items():
                names[f"layer_{i}.{port}.{leaf}"] = \
                    f"deberta.encoder.layer.{i}.{hf}.{leaf}"
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: DebertaV2Config) -> dict:
    """An HF ``DebertaV2*`` state dict -> the port's state dict (encoder
    under ``deberta.``; a head's tensors when the checkpoint has them
    all). A missing encoder tensor raises ``KeyError``."""
    out = {f"deberta.{port}": state_dict[hf]
           for port, hf in _encoder_names(config).items()}
    for names in (_MLM_NAMES, _CLS_NAMES):
        if all(hf in state_dict for hf in names.values()):
            out.update({port: state_dict[hf] for port, hf in names.items()})
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: DebertaV2Config) -> dict:
    """The port's state dict (encoder under ``deberta.``; a head if
    present) -> an HF ``DebertaV2*`` state dict."""
    out = {hf: state_dict[f"deberta.{port}"]
           for port, hf in _encoder_names(config).items()
           if f"deberta.{port}" in state_dict}
    for names in (_MLM_NAMES, _CLS_NAMES):
        out.update({hf: state_dict[port] for port, hf in names.items()
                    if port in state_dict})
    if "cls.predictions.bias" in out:
        out["cls.predictions.decoder.weight"] = \
            out["deberta.embeddings.word_embeddings.weight"]
        out["cls.predictions.decoder.bias"] = out["cls.predictions.bias"]
    return out


def params_from_jax(params: Mapping, config: DebertaV2Config) -> dict:
    """The JAX package's flax param tree of a DeBERTa-v2 module -> the
    port's state dict of fp32 tensors (flax's ``Conv`` kernel ``[k, in,
    out]`` becomes ``Conv1d``'s ``[out, in, k]``)."""
    del config
    tree, convs = _without_convs(params)
    return flax_to_state(tree) | convs


def _without_convs(tree: Mapping, prefix: str = "") -> tuple:
    """``(a copy of tree without its conv modules, those as the port's
    tensors)``."""
    rest, convs = {}, {}
    for key, value in tree.items():
        if key == "conv" and isinstance(value, Mapping):
            convs[f"{prefix}conv.weight"] = tensor(value, "kernel").permute(
                2, 1, 0).contiguous()
            convs[f"{prefix}conv.bias"] = tensor(value, "bias")
        elif isinstance(value, Mapping):
            rest[key], inner = _without_convs(value, f"{prefix}{key}.")
            convs.update(inner)
        else:
            rest[key] = value
    return rest, convs
