"""Weights into and out of the port's DeltaLM (the port of
``fengshen_tpu/models/deltalm/convert.py``).

- :func:`torch_to_params` (:26-80): an HF / fairseq-style DeltaLM state
  dict (with or without the ``model.`` prefix) -> the port's state dict.
  The reference's decoder layer runs ``fc3``/``fc4`` under
  ``ffn_layer_norm`` right after self-attention and ``fc1``/``fc2``
  under ``final_layer_norm`` last; the port names them in execution
  order (``fc1``/``fc2`` under ``ffn1_layer_norm``, then ``fc3``/``fc4``
  under ``ffn2_layer_norm``), so the pairs swap. The token table is
  ``encoder.embed_tokens`` (else ``shared``), the position table
  ``encoder.embed_positions``.
- :func:`params_to_torch_state`: its inverse, an HF-named export under
  ``model.`` with the tied ``embed_tokens`` and ``lm_head`` written as
  ``shared`` and the one position table as both stacks'.
- :func:`load_hf_pretrained` / :func:`load_hf_weights` and
  :func:`params_from_jax` (the JAX tree: ``shared``,
  ``embed_positions``, ``encoder_layer_{i}`` ... at the root).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.deltalm.modeling_deltalm import DeltaLMConfig
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     read_hf_state)

_ATTN = tuple(f"{p}.{leaf}" for p in ("q_proj", "k_proj", "v_proj",
                                      "out_proj")
              for leaf in ("weight", "bias"))
_WB = ("weight", "bias")

#: port sub-module -> reference sub-module, per layer
_ENCODER_LAYER = {"self_attn": "self_attn",
                  "self_attn_layer_norm": "self_attn_layer_norm",
                  "fc1": "fc1", "fc2": "fc2",
                  "final_layer_norm": "final_layer_norm"}
_DECODER_LAYER = {"self_attn": "self_attn",
                  "self_attn_layer_norm": "self_attn_layer_norm",
                  "fc1": "fc3", "fc2": "fc4",
                  "ffn1_layer_norm": "ffn_layer_norm",
                  "encoder_attn": "encoder_attn",
                  "encoder_attn_layer_norm": "encoder_attn_layer_norm",
                  "fc3": "fc1", "fc4": "fc2",
                  "ffn2_layer_norm": "final_layer_norm"}
_NORMS = {"encoder_emb_layer_norm": "encoder.layernorm_embedding",
          "decoder_emb_layer_norm": "decoder.layernorm_embedding",
          "encoder_layer_norm": "encoder.layer_norm",
          "decoder_layer_norm": "decoder.layer_norm"}


def _strip(state_dict: Mapping[str, Any]) -> dict:
    """The ``model.``-prefixed entries without it, when there are any."""
    if any(k.startswith("model.") for k in state_dict):
        return {k[len("model."):]: v for k, v in state_dict.items()
                if k.startswith("model.")}
    return dict(state_dict)


def _names(config: DeltaLMConfig, embed: str) -> dict:
    """``{port name: reference name}`` of every parameter (the token
    table read from ``embed``)."""
    names = {"shared.weight": embed,
             "embed_positions.weight": "encoder.embed_positions.weight"}
    for port, ref in _NORMS.items():
        for leaf in _WB:
            names[f"{port}.{leaf}"] = f"{ref}.{leaf}"
    for side, n_layers, subs in (
            ("encoder", config.encoder_layers, _ENCODER_LAYER),
            ("decoder", config.decoder_layers, _DECODER_LAYER)):
        for i in range(n_layers):
            for port, ref in subs.items():
                leaves = _ATTN if port.endswith("attn") else _WB
                for leaf in leaves:
                    names[f"{side}_layer_{i}.{port}.{leaf}"] = \
                        f"{side}.layers.{i}.{ref}.{leaf}"
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: DeltaLMConfig) -> dict:
    """A reference DeltaLM state dict -> the port's state dict (tensors
    as stored). A missing tensor raises ``KeyError``."""
    sd = _strip(state_dict)
    embed = "encoder.embed_tokens.weight" \
        if "encoder.embed_tokens.weight" in sd else "shared.weight"
    return {port: torch.as_tensor(sd[ref])
            for port, ref in _names(config, embed).items()}


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: DeltaLMConfig) -> dict:
    """The port's state dict -> an HF-named DeltaLM state dict."""
    out = {f"model.{ref}": state_dict[port] for port, ref in
           _names(config, "shared.weight").items()}
    shared = out["model.shared.weight"]
    for name in ("model.encoder.embed_tokens.weight",
                 "model.decoder.embed_tokens.weight", "lm_head.weight"):
        out[name] = shared
    out["model.decoder.embed_positions.weight"] = \
        out["model.encoder.embed_positions.weight"]
    return out


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy a DeltaLM checkpoint directory into ``model`` in place."""
    model.load_state_dict(torch_to_params(read_hf_state(path),
                                          model.config))


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[DeltaLMConfig] = None,
                       device=None):
    """Load a DeltaLM checkpoint directory into ``(config, model)`` on
    ``device`` (``None`` meaning ``cuda``)."""
    from fengshen_tpu_torch.models.deltalm.modeling_deltalm import \
        DeltaLMForConditionalGeneration
    config = config or DeltaLMConfig.from_pretrained(path)
    state = torch_to_params(read_hf_state(path), config)
    model = DeltaLMForConditionalGeneration(
        config, device=resolve_device(device), init=False)
    model.load_state_dict(state)
    return config, model


def params_from_jax(params: Mapping, config: DeltaLMConfig) -> dict:
    """The JAX package's flax param tree -> the port's state dict of
    fp32 tensors."""
    del config
    return flax_to_state(params)
