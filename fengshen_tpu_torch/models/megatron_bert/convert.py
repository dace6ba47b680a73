"""Weights into and out of the port's MegatronBert (the port of
``fengshen_tpu/models/megatron_bert/convert.py``).

- :func:`torch_to_params` (:15-85): an HF ``MegatronBert*`` state dict
  (``bert.encoder.layer.N.attention.ln``, ``...attention.self.query``,
  ...) -> the port's state dict, with the heads ``head`` names, as the
  reference maps it. HF's ``[out, in]`` weights are the port's layout,
  so the map renames; it reads only the names it needs.
- :func:`params_to_torch_state` (:87): the port's state dict -> an HF
  state dict, with the decoder tied to the word embeddings as HF saves
  it, so a checkpoint trained here loads into ``transformers``.
- :func:`params_from_jax`: the JAX package's flax tree, per-layer
  (``layer_{i}``) or scanned (``layer``, stacked on ``[L]``) -> the
  port's state dict.
"""

from __future__ import annotations

from typing import Any, Mapping

from fengshen_tpu_torch.models.megatron_bert.configuration_megatron_bert \
    import MegatronBertConfig
from fengshen_tpu_torch.utils.convert_common import flax_to_state

#: the port's names in a layer -> HF's, under ``bert.encoder.layer.N.``
_LAYER_NAMES = {
    "attention_ln": "attention.ln",
    "self.query": "attention.self.query",
    "self.key": "attention.self.key",
    "self.value": "attention.self.value",
    "attention_output_dense": "attention.output.dense",
    "ln": "ln",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
}


def _encoder_names(config: MegatronBertConfig) -> dict:
    """``{port name under bert.: HF name}`` of the encoder, pooler
    included."""
    names = {f"{e}_embeddings.weight": f"bert.embeddings.{e}_embeddings."
             f"weight" for e in ("word", "position", "token_type")}
    for i in range(config.num_hidden_layers):
        for port, hf in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                names[f"layer_{i}.{port}.{leaf}"] = \
                    f"bert.encoder.layer.{i}.{hf}.{leaf}"
    for leaf in ("weight", "bias"):
        names[f"ln.{leaf}"] = f"bert.encoder.ln.{leaf}"
        names[f"pooler.{leaf}"] = f"bert.pooler.dense.{leaf}"
    return names


#: head names: the port's -> HF's
_MLM_NAMES = {
    "cls_predictions.transform_dense.weight":
        "cls.predictions.transform.dense.weight",
    "cls_predictions.transform_dense.bias":
        "cls.predictions.transform.dense.bias",
    "cls_predictions.transform_ln.weight":
        "cls.predictions.transform.LayerNorm.weight",
    "cls_predictions.transform_ln.bias":
        "cls.predictions.transform.LayerNorm.bias",
    "cls_predictions.bias": "cls.predictions.bias",
}
_SOP_NAMES = {"cls_seq_relationship.weight": "cls.seq_relationship.weight",
              "cls_seq_relationship.bias": "cls.seq_relationship.bias"}
_CLASSIFIER_NAMES = {"classifier.weight": "classifier.weight",
                     "classifier.bias": "classifier.bias"}


def torch_to_params(state_dict: Mapping[str, Any],
                    config: MegatronBertConfig,
                    head: str = "pretraining") -> dict:
    """An HF ``MegatronBert*`` state dict -> the port's state dict
    (encoder under ``bert.``). ``head`` is one of ``pretraining``,
    ``masked_lm``, ``sequence_classification``,
    ``token_classification`` or ``none``; a head's tensors are taken when
    the checkpoint has them, and so is the pooler. A missing encoder
    tensor raises ``KeyError``."""
    out = {}
    for port, hf in _encoder_names(config).items():
        if port.startswith("pooler.") and hf not in state_dict:
            continue
        out[f"bert.{port}"] = state_dict[hf]
    heads = {"pretraining": (_MLM_NAMES, _SOP_NAMES),
             "masked_lm": (_MLM_NAMES,),
             "sequence_classification": (_CLASSIFIER_NAMES,),
             "token_classification": (_CLASSIFIER_NAMES,),
             "none": ()}[head]
    for names in heads:
        if all(hf in state_dict for hf in names.values()):
            out.update({port: state_dict[hf] for port, hf in names.items()})
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: MegatronBertConfig) -> dict:
    """The port's state dict (encoder under ``bert.``; any heads) -> an
    HF ``MegatronBert*`` state dict; with an MLM head the decoder is
    written tied to the word embeddings, as HF saves it."""
    out = {}
    for port, hf in _encoder_names(config).items():
        if f"bert.{port}" in state_dict:
            out[hf] = state_dict[f"bert.{port}"]
    for names in (_MLM_NAMES, _SOP_NAMES, _CLASSIFIER_NAMES):
        out.update({hf: state_dict[port] for port, hf in names.items()
                    if port in state_dict})
    if "cls.predictions.bias" in out:
        out["cls.predictions.decoder.weight"] = \
            out["bert.embeddings.word_embeddings.weight"]
        out["cls.predictions.decoder.bias"] = out["cls.predictions.bias"]
    return out


def params_from_jax(params: Mapping, config: MegatronBertConfig) -> dict:
    """The JAX package's flax param tree of any MegatronBert module (the
    encoder, a head, or a tree holding one, such as the classification
    ``TaskModel``'s) -> the port's state dict of fp32 tensors, unrolling
    a scanned ``layer`` stack into ``layer_{i}``."""
    del config
    return flax_to_state(params)
