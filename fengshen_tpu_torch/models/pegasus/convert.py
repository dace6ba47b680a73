"""Weights into and out of the port's Pegasus (the port of
``fengshen_tpu/models/pegasus/convert.py``): :func:`torch_to_params`
(:14-55) maps an HF ``PegasusForConditionalGeneration`` state dict onto
the port's names (``model.encoder.layers.{i}`` -> ``encoder_layer_{i}``,
``model.encoder.layer_norm`` -> ``encoder_layer_norm``; the sinusoidal
position tables are not read: the port computes them);
:func:`params_to_torch_state` is its inverse, an HF-named export with
the tied ``embed_tokens`` and ``lm_head`` and the sinusoidal tables
written out; :func:`load_hf_pretrained`, :func:`load_hf_weights` and
:func:`params_from_jax` as for BART.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.bart.convert import layer_names
from fengshen_tpu_torch.models.pegasus.modeling_pegasus import (
    PegasusConfig, sinusoidal_positions)
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     read_hf_state)


def _names(config: PegasusConfig) -> dict:
    """``{port name: HF name}`` of every parameter but
    ``final_logits_bias``."""
    names = {"shared.weight": "model.shared.weight"}
    for side, n_layers in (("encoder", config.encoder_layers),
                           ("decoder", config.decoder_layers)):
        for leaf in ("weight", "bias"):
            names[f"{side}_layer_norm.{leaf}"] = \
                f"model.{side}.layer_norm.{leaf}"
        for i in range(n_layers):
            names.update(layer_names(f"{side}_layer_{i}",
                                     f"model.{side}.layers.{i}",
                                     side == "decoder"))
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: PegasusConfig) -> dict:
    """An HF Pegasus state dict -> the port's state dict (tensors as
    stored). A missing tensor raises ``KeyError``."""
    out = {port: torch.as_tensor(state_dict[hf])
           for port, hf in _names(config).items()}
    out["final_logits_bias"] = torch.as_tensor(
        state_dict["final_logits_bias"]).reshape(-1)
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: PegasusConfig) -> dict:
    """The port's state dict -> an HF ``PegasusForConditionalGeneration``
    state dict."""
    out = {hf: state_dict[port] for port, hf in _names(config).items()}
    shared = out["model.shared.weight"]
    for name in ("model.encoder.embed_tokens.weight",
                 "model.decoder.embed_tokens.weight", "lm_head.weight"):
        out[name] = shared
    table = sinusoidal_positions(config.max_position_embeddings,
                                 config.d_model)
    out["model.encoder.embed_positions.weight"] = table
    out["model.decoder.embed_positions.weight"] = table
    out["final_logits_bias"] = state_dict["final_logits_bias"].reshape(1, -1)
    return out


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy an HF Pegasus checkpoint directory into ``model`` in place."""
    model.load_state_dict(torch_to_params(read_hf_state(path),
                                          model.config))


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[PegasusConfig] = None,
                       device=None):
    """Load an HF Pegasus checkpoint directory into ``(config, model)``
    on ``device`` (``None`` meaning ``cuda``)."""
    from fengshen_tpu_torch.models.pegasus.modeling_pegasus import \
        PegasusForConditionalGeneration
    config = config or PegasusConfig.from_pretrained(path)
    state = torch_to_params(read_hf_state(path), config)
    model = PegasusForConditionalGeneration(
        config, device=resolve_device(device), init=False)
    model.load_state_dict(state)
    return config, model


def params_from_jax(params: Mapping, config: PegasusConfig) -> dict:
    """The JAX package's flax param tree -> the port's state dict of
    fp32 tensors."""
    del config
    return flax_to_state(params)
