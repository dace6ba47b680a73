"""Weights into and out of the port's GPT-2 (the port of
``fengshen_tpu/models/gpt2/convert.py``).

- :func:`torch_to_params` (:19-54): an HF ``GPT2LMHeadModel`` (or
  ``GPT2Model``) state dict -> the port's state dict. HF's ``Conv1D``
  stores its weight ``[in, out]`` and the port's ``nn.Linear`` ``[out,
  in]``, so the projections are transposed; a state dict without the
  ``transformer.`` prefix (a bare ``GPT2Model``'s) is read as if it had
  it (:77-79). HF's tied ``lm_head.weight`` and its attention buffers
  are not read.
- :func:`params_to_torch_state`: the exact inverse, an HF-named export
  that ``transformers`` loads (the head tied to ``wte``).
- :func:`load_hf_pretrained` (:56): a checkpoint directory
  (``*.safetensors``, read by ``utils/convert_common.py``, else
  ``pytorch_model*.bin``) -> ``(config, model)`` on the device;
  :func:`load_hf_weights` copies one into a model that exists.
- :func:`params_from_jax`: the JAX package's flax tree, per-layer
  (``h_{i}``) or scanned (``h``, stacked on ``[L]``) -> the port's
  state dict.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.gpt2.configuration_gpt2 import GPT2Config
from fengshen_tpu_torch.utils.convert_common import (flax_to_state,
                                                     read_hf_state)

#: the port's names in block ``i`` -> HF's under ``transformer.h.{i}.``,
#: and whether the tensor is a ``Conv1D`` weight (transposed)
_BLOCK_NAMES = {
    "ln_1.weight": ("ln_1.weight", False),
    "ln_1.bias": ("ln_1.bias", False),
    "attn.c_attn.weight": ("attn.c_attn.weight", True),
    "attn.c_attn.bias": ("attn.c_attn.bias", False),
    "attn.c_proj.weight": ("attn.c_proj.weight", True),
    "attn.c_proj.bias": ("attn.c_proj.bias", False),
    "ln_2.weight": ("ln_2.weight", False),
    "ln_2.bias": ("ln_2.bias", False),
    "c_fc.weight": ("mlp.c_fc.weight", True),
    "c_fc.bias": ("mlp.c_fc.bias", False),
    "c_proj.weight": ("mlp.c_proj.weight", True),
    "c_proj.bias": ("mlp.c_proj.bias", False),
}


def _names(config: GPT2Config) -> dict:
    """``{port name: (HF name, transposed)}`` of every parameter."""
    names = {f"transformer.{k}": (f"transformer.{k}", False) for k in (
        "wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias")}
    for i in range(config.n_layer):
        for port, (hf, conv) in _BLOCK_NAMES.items():
            names[f"transformer.h_{i}.{port}"] = \
                (f"transformer.h.{i}.{hf}", conv)
    return names


def _with_prefix(state_dict: Mapping[str, Any]) -> Mapping[str, Any]:
    if any(k.startswith("transformer.") for k in state_dict):
        return state_dict
    return {f"transformer.{k}": v for k, v in state_dict.items()
            if not k.startswith("lm_head")}


def torch_to_params(state_dict: Mapping[str, Any],
                    config: GPT2Config) -> dict:
    """An HF GPT-2 state dict -> the port's state dict (tensors as
    stored, ``Conv1D`` weights transposed). A missing tensor raises
    ``KeyError``."""
    state_dict = _with_prefix(state_dict)
    out = {}
    for port, (hf, conv) in _names(config).items():
        t = torch.as_tensor(state_dict[hf])
        out[port] = t.T.contiguous() if conv else t
    return out


def params_to_torch_state(state_dict: Mapping[str, Any],
                          config: GPT2Config) -> dict:
    """The port's state dict -> an HF ``GPT2LMHeadModel`` state dict
    (``lm_head.weight`` left out: HF ties it to ``wte`` on load)."""
    out = {}
    for port, (hf, conv) in _names(config).items():
        t = state_dict[port]
        out[hf] = t.T.contiguous() if conv else t
    return out


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy an HF GPT-2 checkpoint directory into ``model``'s parameters
    in place (on their device, in their dtype)."""
    model.load_state_dict(torch_to_params(read_hf_state(path),
                                          model.config))


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[GPT2Config] = None,
                       device=None):
    """Load an HF GPT-2 checkpoint directory into ``(config, model)``
    (the reference returns flax params; the port a
    :class:`GPT2LMHeadModel` on ``device``, ``None`` meaning ``cuda``).
    ``config`` defaults to the directory's ``config.json``."""
    from fengshen_tpu_torch.models.gpt2.modeling_gpt2 import \
        GPT2LMHeadModel
    config = config or GPT2Config.from_pretrained(path)
    state = torch_to_params(read_hf_state(path), config)
    model = GPT2LMHeadModel(config, device=resolve_device(device),
                            init=False)
    model.load_state_dict(state)
    return config, model


def params_from_jax(params: Mapping, config: GPT2Config) -> dict:
    """The JAX package's flax param tree of ``GPT2LMHeadModel`` (or of a
    tree holding its ``transformer``) -> the port's state dict of fp32
    tensors, unrolling a scanned ``h`` stack into ``h_{i}``."""
    del config
    return flax_to_state(params, scan_name="h", layer_name="h_{}")
