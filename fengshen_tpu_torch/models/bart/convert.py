"""Weights into and out of the port's BART (the port of
``fengshen_tpu/models/bart/convert.py``).

- :func:`torch_to_params` (:14-64): an HF ``BartForConditionalGeneration``
  state dict -> the port's state dict (HF's ``nn.Linear`` weights are
  ``[out, in]`` like the port's: nothing is transposed). The stacks'
  ``layers.{i}`` become ``encoder_layer_{i}`` / ``decoder_layer_{i}``,
  ``embed_positions`` and ``layernorm_embedding`` move under the model
  as ``encoder_embed_positions`` and so on, and ``final_logits_bias``
  (``[1, V]`` in HF) is read flat when the checkpoint has it.
- :func:`params_to_torch_state`: the exact inverse, an HF-named export
  with the tied ``embed_tokens`` and ``lm_head`` written as ``shared``
  (the reference derives its export from a template checkpoint).
- :func:`load_hf_pretrained` / :func:`load_hf_weights` and
  :func:`params_from_jax` (the JAX tree, ``model`` with
  ``encoder_layer_{i}`` and ``decoder_layer_{i}``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.bart.modeling_bart import BartConfig
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     read_hf_state)

_ATTN = tuple(f"{p}.{leaf}" for p in ("q_proj", "k_proj", "v_proj",
                                      "out_proj")
              for leaf in ("weight", "bias"))
_WB = ("weight", "bias")


def layer_names(port: str, hf: str, decoder: bool) -> dict:
    """``{port name: HF name}`` of one encoder or decoder layer (shared
    by Pegasus, whose layers carry the same names)."""
    subs = ["self_attn", "self_attn_layer_norm", "fc1", "fc2",
            "final_layer_norm"]
    if decoder:
        subs += ["encoder_attn", "encoder_attn_layer_norm"]
    out = {}
    for sub in subs:
        leaves = _ATTN if sub in ("self_attn", "encoder_attn") else _WB
        for leaf in leaves:
            out[f"{port}.{sub}.{leaf}"] = f"{hf}.{sub}.{leaf}"
    return out


def _names(config: BartConfig) -> dict:
    """``{port name: HF name}`` of every parameter but
    ``final_logits_bias``."""
    names = {"model.shared.weight": "model.shared.weight"}
    for side, n_layers in (("encoder", config.encoder_layers),
                           ("decoder", config.decoder_layers)):
        names[f"model.{side}_embed_positions.weight"] = \
            f"model.{side}.embed_positions.weight"
        for leaf in _WB:
            names[f"model.{side}_layernorm_embedding.{leaf}"] = \
                f"model.{side}.layernorm_embedding.{leaf}"
        for i in range(n_layers):
            names.update(layer_names(f"model.{side}_layer_{i}",
                                     f"model.{side}.layers.{i}",
                                     side == "decoder"))
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: BartConfig) -> dict:
    """An HF BART state dict -> the port's state dict (tensors as
    stored). A missing tensor raises ``KeyError``."""
    out = {port: torch.as_tensor(state_dict[hf])
           for port, hf in _names(config).items()}
    if "final_logits_bias" in state_dict:
        out["final_logits_bias"] = torch.as_tensor(
            state_dict["final_logits_bias"]).reshape(-1)
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: BartConfig) -> dict:
    """The port's state dict -> an HF ``BartForConditionalGeneration``
    state dict."""
    out = {hf: state_dict[port] for port, hf in _names(config).items()}
    shared = out["model.shared.weight"]
    for name in ("model.encoder.embed_tokens.weight",
                 "model.decoder.embed_tokens.weight", "lm_head.weight"):
        out[name] = shared
    if "final_logits_bias" in state_dict:
        out["final_logits_bias"] = state_dict["final_logits_bias"].reshape(
            1, -1)
    return out


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy an HF BART checkpoint directory into ``model`` in place; a
    checkpoint without ``final_logits_bias`` leaves the model's."""
    state = torch_to_params(read_hf_state(path), model.config)
    model.load_state_dict(state, strict="final_logits_bias" in state)


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[BartConfig] = None,
                       device=None):
    """Load an HF BART checkpoint directory into ``(config, model)``: a
    :class:`BartForConditionalGeneration` on ``device`` (``None``
    meaning ``cuda``), its ``final_logits_bias`` 0 when the checkpoint
    has none."""
    from fengshen_tpu_torch.models.bart.modeling_bart import \
        BartForConditionalGeneration
    config = config or BartConfig.from_pretrained(path)
    model = BartForConditionalGeneration(
        config, device=resolve_device(device), init=False)
    model.final_logits_bias.zero_()
    load_hf_weights(path, model)
    return config, model


def params_from_jax(params: Mapping, config: BartConfig) -> dict:
    """The JAX package's flax param tree of a BART head -> the port's
    state dict of fp32 tensors."""
    del config
    return flax_to_state(params)
