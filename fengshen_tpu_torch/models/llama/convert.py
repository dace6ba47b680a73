"""Weights from the JAX package into the port.

:func:`params_from_jax` follows the map of the reference's
``fengshen_tpu/models/llama/convert.py:68 params_to_torch_state`` (copied,
not imported): flax ``Dense`` kernels are ``[in, out]`` and become
``nn.Linear`` weights ``[out, in]``; norm ``scale`` becomes ``weight``;
the scan layout's stacked ``[L]`` leaves are unstacked per layer.
:func:`params_to_numpy` goes the other way, so a test can hold the
port's parameters after training steps against the JAX package's.
Parameters are fp32 master copies (``param_dtype="float32"``) whatever
the compute dtype, as ``configuration_llama.py`` sets by default.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fengshen_tpu_torch.models.llama.configuration_llama import LlamaConfig


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _index_tree(tree: Mapping, i: int) -> dict:
    """``tree_map(lambda x: x[i], tree)`` over nested dicts."""
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in tree.items()}


def params_from_jax(params: Mapping, config: LlamaConfig) -> dict:
    """The JAX package's flax param tree (as numpy arrays, or anything
    ``np.array`` takes) -> the port's ``state_dict`` (fp32 tensors;
    ``load_state_dict`` casts them to the model's ``param_dtype``).
    Takes the ``scan_layers`` layout (``params["model"]["layers"]["layer"]``
    stacked on a leading ``[L]``) or the unrolled ``layers_{i}`` one."""
    out: dict = {}
    model = params["model"]
    out["model.embed_tokens.weight"] = _tensor(
        model["embed_tokens"]["embedding"])

    def layer_view(i: int):
        if config.scan_layers:
            return _index_tree(model["layers"]["layer"], i)
        return model[f"layers_{i}"]

    for i in range(config.num_hidden_layers):
        layer = layer_view(i)
        pre = f"model.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{pre}.self_attn.{proj}.weight"] = _tensor(
                layer["self_attn"][proj]["kernel"]).T.contiguous()
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"{pre}.mlp.{proj}.weight"] = _tensor(
                layer["mlp"][proj]["kernel"]).T.contiguous()
        out[f"{pre}.input_layernorm.weight"] = _tensor(
            layer["input_layernorm"]["scale"])
        out[f"{pre}.post_attention_layernorm.weight"] = _tensor(
            layer["post_attention_layernorm"]["scale"])
    out["model.norm.weight"] = _tensor(model["norm"]["scale"])
    if "lm_head" in params:
        out["lm_head.weight"] = _tensor(
            params["lm_head"]["kernel"]).T.contiguous()
    return out


def params_to_numpy(state_dict: Mapping, config: LlamaConfig) -> dict:
    """The reverse of :func:`params_from_jax`: the port's ``state_dict``
    -> the JAX package's flax param tree as fp32 numpy arrays, in the
    ``scan_layers`` layout (layer leaves stacked on a leading ``[L]``)
    or the unrolled one, as ``config.scan_layers`` says."""
    def arr(name: str, transpose: bool = False) -> np.ndarray:
        t = state_dict[name].detach().to("cpu", torch.float32)
        return (t.T if transpose else t).contiguous().numpy()

    def layer(i: int) -> dict:
        pre = f"model.layers.{i}"
        return {
            "self_attn": {proj: {"kernel": arr(
                f"{pre}.self_attn.{proj}.weight", True)}
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {proj: {"kernel": arr(f"{pre}.mlp.{proj}.weight", True)}
                    for proj in ("gate_proj", "up_proj", "down_proj")},
            "input_layernorm": {"scale": arr(
                f"{pre}.input_layernorm.weight")},
            "post_attention_layernorm": {"scale": arr(
                f"{pre}.post_attention_layernorm.weight")},
        }

    def stack(trees: list):
        if isinstance(trees[0], Mapping):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    model: dict = {"embed_tokens": {"embedding": arr(
        "model.embed_tokens.weight")},
        "norm": {"scale": arr("model.norm.weight")}}
    layers = [layer(i) for i in range(config.num_hidden_layers)]
    if config.scan_layers:
        model["layers"] = {"layer": stack(layers)}
    else:
        model.update({f"layers_{i}": t for i, t in enumerate(layers)})
    out = {"model": model}
    if "lm_head.weight" in state_dict:
        out["lm_head"] = {"kernel": arr("lm_head.weight", True)}
    return out
