"""Weights into the port: from an HF checkpoint directory, and from the
JAX package.

:func:`load_hf_pretrained` is the port of the reference's
``fengshen_tpu/models/llama/convert.py:106``: it reads an HF LLaMA
checkpoint directory (``*.safetensors`` if there are any, sorted, else
``pytorch_model*.bin``, sorted) and copies it tensor by tensor into a
model on its device in ``param_dtype``, so the host never holds more
than one tensor of it. The safetensors format is read here (an 8-byte
little-endian header length, a JSON header of ``dtype``, ``shape`` and
``data_offsets``, then the raw bytes) by ``utils/convert_common.py``,
with no ``safetensors`` package; ``.bin`` files go through
``torch.load(weights_only=True, mmap=True)``.
The port's modules use HF's names and ``[out, in]`` layout, so the map
of the reference's ``torch_to_params`` (:22) is a check of the names
(:func:`torch_to_params`).

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

from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.llama.configuration_llama import LlamaConfig
from fengshen_tpu_torch.utils.convert_common import (  # noqa: F401
    SAFETENSORS_DTYPES, check_safetensors_complete, checkpoint_files,
    iter_safetensors, read_safetensors_header, write_safetensors,
    write_safetensors_stream)


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


# -- HF checkpoint directories ---------------------------------------------

#: non-parameter buffers some HF checkpoints carry: the rotary
#: frequencies, which the port computes from ``rope_theta``
_SKIPPED_SUFFIXES = (".rotary_emb.inv_freq",)


def hf_param_names(config: LlamaConfig) -> list:
    """The parameter names of an HF ``LlamaForCausalLM`` of ``config``
    (the port's ``state_dict`` keys): no ``lm_head.weight`` under
    ``tie_word_embeddings``."""
    names = ["model.embed_tokens.weight"]
    for i in range(config.num_hidden_layers):
        pre = f"model.layers.{i}"
        names += [f"{pre}.self_attn.{p}.weight"
                  for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
        names += [f"{pre}.mlp.{p}.weight"
                  for p in ("gate_proj", "up_proj", "down_proj")]
        names += [f"{pre}.input_layernorm.weight",
                  f"{pre}.post_attention_layernorm.weight"]
    names.append("model.norm.weight")
    if not config.tie_word_embeddings:
        names.append("lm_head.weight")
    return names


def torch_to_params(state_dict: Mapping[str, Any],
                    config: LlamaConfig) -> dict:
    """An HF ``LlamaForCausalLM.state_dict()`` -> the port's state dict
    (the reference's ``torch_to_params``, :22). The names and layouts
    are the same, so this checks them: a missing or unexpected name
    raises ``KeyError`` naming it. HF's rotary ``inv_freq`` buffers are
    dropped, and so is ``lm_head.weight`` under ``tie_word_embeddings``
    (the embedding's alias), as the reference reads neither."""
    keys = _checked_keys(state_dict.keys(), config)
    return {k: state_dict[k] for k in keys}


def _checked_keys(keys, config: LlamaConfig) -> list:
    want = hf_param_names(config)
    have = set(keys)
    missing = [k for k in want if k not in have]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameter(s) of "
                       f"the config: {missing[:8]}")
    extra = sorted(k for k in have - set(want)
                   if not k.endswith(_SKIPPED_SUFFIXES) and not (
                       k == "lm_head.weight" and config.tie_word_embeddings))
    if extra:
        raise KeyError(f"checkpoint has {len(extra)} unexpected "
                       f"tensor(s): {extra[:8]}")
    return want


def _file_keys(fmt: str, path: str) -> list:
    if fmt == "safetensors":
        return [k for k in read_safetensors_header(path)[0]
                if k != "__metadata__"]
    return list(torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True).keys())


def _iter_file(fmt: str, path: str, names) -> Iterator[tuple]:
    if fmt == "safetensors":
        yield from iter_safetensors(path, names)
        return
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    for name in list(state):
        if name in names:
            yield name, state.pop(name)


def _owners(path: str) -> tuple:
    """``(format, files, {name: file})`` of a checkpoint directory, from
    the files' headers (a name in two files belongs to the later one, as
    the reference's dict update does)."""
    fmt, files = checkpoint_files(path)
    owner: dict = {}
    for f in files:
        for k in _file_keys(fmt, f):
            owner[k] = f
    return fmt, files, owner


@torch.no_grad()
def load_hf_weights(path: str, model: torch.nn.Module) -> None:
    """Copy an HF LLaMA checkpoint directory into ``model``'s parameters
    in place (on their device, in their dtype), tensor by tensor, after
    checking every name against the model's config (``KeyError``) and
    every shape (``ValueError``)."""
    fmt, files, owner = _owners(path)
    names = _checked_keys(owner.keys(), model.config)
    params = dict(model.named_parameters())
    for f in files:
        mine = {k for k in names if owner[k] == f}
        for name, tensor in _iter_file(fmt, f, mine):
            param = params[name]
            if tuple(tensor.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(tensor.shape)}, "
                    f"model shape {tuple(param.shape)}")
            param.copy_(tensor)


def lora_from_jax(lora: Mapping, config: LlamaConfig) -> dict:
    """The ``lora`` half of the JAX package's LoRA two-tree
    (``{'base', 'lora'}``, ``fengshen_tpu/ops/lora.py:44 init_lora``) ->
    the port's adapter entries of the decoder layers' projections
    (``...q_proj.lora_a [in, r]``, ``.lora_b [r, out]``,
    ``.lora_scale``), unstacking the scan layout's ``[L]`` leading
    axis. Load with
    ``model.load_state_dict({**params_from_jax(base), **this},
    strict=False)`` after adapting the same projections
    (:func:`fengshen_tpu_torch.ops.lora.init_lora`)."""
    out: dict = {}
    model = lora.get("model", {})

    def leaves(node, prefix):
        for proj_group in ("self_attn", "mlp"):
            for proj, ad in node.get(proj_group, {}).items():
                yield f"{prefix}.{proj_group}.{proj}", ad

    for i in range(config.num_hidden_layers):
        if config.scan_layers:
            layer = _index_stacked(model["layers"]["layer"], i) \
                if "layers" in model else {}
        else:
            layer = model.get(f"layers_{i}", {})
        for name, ad in leaves(layer, f"model.layers.{i}"):
            out[f"{name}.lora_a"] = _tensor(ad["lora_a"])
            out[f"{name}.lora_b"] = _tensor(ad["lora_b"])
    scales = _scales(lora)
    for name in [k[:-len(".lora_a")] for k in out if k.endswith(".lora_a")]:
        out[f"{name}.lora_scale"] = torch.tensor(scales, dtype=torch.float32)
    return out


def _index_stacked(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a scan-layout adapter tree (the scalar
    ``lora_scale`` leaves are not stacked)."""
    return {k: _index_stacked(v, i) if isinstance(v, Mapping) else
            (v if np.ndim(v) == 0 else v[i]) for k, v in tree.items()}


def _scales(tree) -> float:
    """The one stored ``lora_scale`` of a JAX adapter tree (every target
    carries the same ``alpha / rank``)."""
    found = set()

    def walk(node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v)
            elif k == "lora_scale":
                found.update(float(x) for x in np.ravel(np.asarray(v)))

    walk(tree)
    if len(found) != 1:
        raise ValueError(f"expected one lora_scale, found {sorted(found)}")
    return found.pop()


@torch.no_grad()
def load_hf_pretrained(path: str, config: Optional[LlamaConfig] = None,
                       device=None):
    """Load an HF LLaMA checkpoint directory into ``(config, model)``
    (the reference returns flax params; the port a model on
    ``device``, ``None`` meaning ``cuda``). ``config`` defaults to the
    directory's ``config.json``.

    Every name is checked before any tensor is read (a missing or
    unexpected one raises ``KeyError`` naming it), then each tensor is
    read alone and copied into its parameter on the device, in
    ``param_dtype``; a shape that differs raises. A name in two files
    takes the later file's tensor, as the reference's dict update does.
    """
    config = config or LlamaConfig.from_pretrained(path)
    # the names are checked before the model is allocated
    _checked_keys(_owners(path)[2].keys(), config)
    from fengshen_tpu_torch.models.llama.modeling_llama import \
        LlamaForCausalLM
    model = LlamaForCausalLM(config, device=resolve_device(device),
                             init=False)
    load_hf_weights(path, model)
    return config, model
