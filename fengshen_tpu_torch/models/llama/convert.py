"""Weights into the port: from an HF checkpoint directory, and from the
JAX package.

:func:`load_hf_pretrained` is the port of the reference's
``fengshen_tpu/models/llama/convert.py:106``: it reads an HF LLaMA
checkpoint directory (``*.safetensors`` if there are any, sorted, else
``pytorch_model*.bin``, sorted) and copies it tensor by tensor into a
model on its device in ``param_dtype``, so the host never holds more
than one tensor of it. The safetensors format is read here (an 8-byte
little-endian header length, a JSON header of ``dtype``, ``shape`` and
``data_offsets``, then the raw bytes), with no ``safetensors`` package;
``.bin`` files go through ``torch.load(weights_only=True, mmap=True)``.
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

import glob
import json
import os
import struct
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from fengshen_tpu_torch.device import resolve_device
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


# -- HF checkpoint directories ---------------------------------------------

#: safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}

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


def read_safetensors_header(path: str) -> tuple:
    """``(header, data_start)`` of a safetensors file: the JSON header
    (tensor name -> ``dtype``, ``shape``, ``data_offsets``; and
    ``__metadata__``) and the byte offset its data starts at."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    return header, 8 + n


def iter_safetensors(path: str, names=None) -> Iterator[tuple]:
    """Yield ``(name, tensor)`` for each tensor of a safetensors file
    (those in ``names`` when given), one at a time, read from disk into
    a CPU tensor of its stored dtype."""
    header, start = read_safetensors_header(path)
    with open(path, "rb") as f:
        for name, info in header.items():
            if name == "__metadata__" or (names is not None and
                                          name not in names):
                continue
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']!r}, which is not read")
            begin, end = info["data_offsets"]
            shape = list(info["shape"])
            if end == begin:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            f.seek(start + begin)
            buf = bytearray(end - begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            yield name, torch.frombuffer(buf, dtype=dtype).reshape(shape)


def checkpoint_files(path: str) -> tuple:
    """``(format, files)`` of a checkpoint directory, as the reference
    picks them (:114-124): every ``*.safetensors`` if there is one,
    sorted, else every ``pytorch_model*.bin``, sorted. A directory with
    neither raises ``FileNotFoundError`` naming what it looked for."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if files:
        return "safetensors", files
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if files:
        return "bin", files
    raise FileNotFoundError(
        f"no weights in {path!r}: looked for *.safetensors and "
        "pytorch_model*.bin")


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
    fmt, files = checkpoint_files(path)
    owner: dict = {}
    for f in files:
        for k in _file_keys(fmt, f):
            owner[k] = f
    names = _checked_keys(owner.keys(), config)
    from fengshen_tpu_torch.models.llama.modeling_llama import \
        LlamaForCausalLM
    model = LlamaForCausalLM(config, device=resolve_device(device),
                             init=False)
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
    return config, model
