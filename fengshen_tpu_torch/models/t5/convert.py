"""Weights into and out of the port's T5 (the port of
``fengshen_tpu/models/t5/convert.py``).

- :func:`torch_to_params` (:14-64): an HF ``T5ForConditionalGeneration``
  state dict -> the port's state dict. HF's ``nn.Linear`` weights are
  ``[out, in]`` like the port's, so nothing is transposed; the relative
  bias table is read from block 0 of each stack; ``lm_head.weight`` is
  read only for an untied config.
- :func:`params_to_torch_state` (:67-129): the exact inverse, an
  HF-named export (``encoder.embed_tokens`` and ``decoder.embed_tokens``
  are ``shared``; a tied config writes ``lm_head.weight`` as ``shared``,
  as the reference does).
- :func:`load_hf_pretrained`: a checkpoint directory (``*.safetensors``,
  else ``pytorch_model*.bin``) -> ``(config, model)`` on the device;
  :func:`load_hf_weights` copies one into a model that exists.
- :func:`params_from_jax`: the JAX package's flax tree (``model`` with
  ``shared``, ``encoder`` and ``decoder`` holding ``block_{i}``, and
  ``lm_head`` when untied) -> the port's state dict.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.t5.configuration_t5 import T5Config
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     read_hf_state)

_ATTN = ("q", "k", "v", "o")


def _names(config: T5Config) -> dict:
    """``{port name: HF name}`` of every parameter."""
    names = {"model.shared.weight": "shared.weight"}
    for side, n_layers, causal in (
            ("encoder", config.num_layers, False),
            ("decoder", config.num_decoder_layers, True)):
        port, hf = f"model.{side}", side
        names[f"{port}.final_layer_norm.weight"] = \
            f"{hf}.final_layer_norm.weight"
        for i in range(n_layers):
            blk, pre = f"{port}.block_{i}", f"{hf}.block.{i}.layer"
            names[f"{blk}.ln_self.weight"] = f"{pre}.0.layer_norm.weight"
            for proj in _ATTN:
                names[f"{blk}.self_attention.{proj}.weight"] = \
                    f"{pre}.0.SelfAttention.{proj}.weight"
            if i == 0:
                names[f"{blk}.self_attention.relative_attention_bias"
                      ".weight"] = \
                    f"{pre}.0.SelfAttention.relative_attention_bias.weight"
            ff_idx = 2 if causal else 1
            if causal:
                names[f"{blk}.ln_cross.weight"] = \
                    f"{pre}.1.layer_norm.weight"
                for proj in _ATTN:
                    names[f"{blk}.cross_attention.{proj}.weight"] = \
                        f"{pre}.1.EncDecAttention.{proj}.weight"
            names[f"{blk}.ln_ff.weight"] = \
                f"{pre}.{ff_idx}.layer_norm.weight"
            ff = ("wi_0", "wi_1", "wo") if config.is_gated_act \
                else ("wi", "wo")
            for proj in ff:
                names[f"{blk}.ff.{proj}.weight"] = \
                    f"{pre}.{ff_idx}.DenseReluDense.{proj}.weight"
    if not config.tie_word_embeddings:
        names["lm_head.weight"] = "lm_head.weight"
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: T5Config) -> dict:
    """An HF T5 state dict -> the port's state dict (tensors as stored).
    A missing tensor raises ``KeyError``."""
    return {port: torch.as_tensor(state_dict[hf])
            for port, hf in _names(config).items()}


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: T5Config) -> dict:
    """The port's state dict -> an HF ``T5ForConditionalGeneration``
    state dict (:67)."""
    out = {hf: state_dict[port] for port, hf in _names(config).items()}
    out["encoder.embed_tokens.weight"] = out["shared.weight"]
    out["decoder.embed_tokens.weight"] = out["shared.weight"]
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["shared.weight"]
    return out


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy an HF T5 checkpoint directory into ``model``'s parameters in
    place (on their device, in their dtype)."""
    model.load_state_dict(torch_to_params(read_hf_state(path),
                                          model.config))


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[T5Config] = None,
                       device=None):
    """Load an HF T5 checkpoint directory into ``(config, model)``: a
    :class:`T5ForConditionalGeneration` on ``device`` (``None`` meaning
    ``cuda``). ``config`` defaults to the directory's ``config.json``."""
    from fengshen_tpu_torch.models.t5.modeling_t5 import \
        T5ForConditionalGeneration
    config = config or T5Config.from_pretrained(path)
    state = torch_to_params(read_hf_state(path), config)
    model = T5ForConditionalGeneration(config, device=resolve_device(device),
                                       init=False)
    model.load_state_dict(state)
    return config, model


def params_from_jax(params: Mapping, config: T5Config) -> dict:
    """The JAX package's flax param tree of ``T5ForConditionalGeneration``
    (or ``T5EncoderModel``) -> the port's state dict of fp32 tensors."""
    del config
    return flax_to_state(params)
