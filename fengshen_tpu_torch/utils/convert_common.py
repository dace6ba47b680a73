"""Weight-conversion helpers shared by the port's families: the port's
counterpart of ``fengshen_tpu/utils/convert_common.py``.

- The safetensors format, read and written here with no ``safetensors``
  package (the card's machine has none): an 8-byte little-endian header
  length, a JSON header of ``dtype``, ``shape`` and ``data_offsets``,
  then the raw bytes. Files are read and written one tensor at a time.
- :func:`checkpoint_files`: the weight files of an HF checkpoint
  directory, as the reference's HF loaders pick them, and
  :func:`read_hf_state`, their state dict.
- :func:`load_torch_checkpoint` (:328): the state dict of a checkpoint
  directory in the file names the reference publishes under
  (``pytorch_model.bin``, a Lightning ``model.ckpt`` / ``last.ckpt``
  with its ``model.`` prefix stripped, or ``*.safetensors``), read
  through ``torch.load(weights_only=True)`` or the reader here.
- :func:`tensor`, :func:`strip_prefix` and :func:`unwrap_lightning`
  (:13, :67, :73), and :func:`flax_to_state`, which turns a flax param
  tree of the JAX package into the port's names: the one map every
  family's ``params_from_jax`` uses.
"""

from __future__ import annotations

import glob
import json
import math
import os
import struct
from typing import Any, Iterable, Iterator, Mapping

import numpy as np
import torch


def tensor(state_dict: Mapping[str, Any], name: str) -> torch.Tensor:
    """``state_dict[name]`` as an fp32 CPU tensor of its own (always a
    copy, so a later in-place update of either side leaves the other
    alone)."""
    x = state_dict[name]
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def strip_prefix(state_dict: Mapping[str, Any], prefix: str) -> dict:
    """The entries under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def unwrap_lightning(state_dict: Mapping[str, Any]) -> Mapping[str, Any]:
    """A Lightning checkpoint's weights: the nested ``state_dict`` entry
    when there is one, with the ``model.`` prefix its module adds
    stripped."""
    if "state_dict" in state_dict and not torch.is_tensor(
            state_dict["state_dict"]):
        state_dict = state_dict["state_dict"]
    if any(k.startswith("model.") for k in state_dict):
        return strip_prefix(state_dict, "model.")
    return state_dict


def _index_tree(tree: Mapping, i: int) -> dict:
    """``tree_map(lambda x: x[i], tree)`` over nested dicts."""
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in tree.items()}


#: flax leaf names -> the port's (``nn.Linear``/``nn.Embedding`` naming)
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_to_state(tree: Mapping, prefix: str = "",
                  scan_name: str = "layer",
                  layer_name: str = "layer_{}") -> dict:
    """A flax param tree (numpy leaves, or anything ``np.array`` takes)
    -> the port's ``state_dict`` of fp32 tensors. Module paths keep the
    reference's names joined by ``.``; a ``kernel [in, out]`` becomes
    ``weight [out, in]``, ``scale`` and ``embedding`` become ``weight``,
    other leaves keep their names. A scanned stack (``scan_name`` holding
    ``{"block": leaves stacked on [L]}``) unrolls into
    ``layer_name.format(i)`` per layer, the unrolled tree's names."""
    out: dict = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            if key == scan_name and set(value) == {"block"}:
                leaf = value["block"]
                while isinstance(leaf, Mapping):
                    leaf = next(iter(leaf.values()))
                for i in range(np.shape(leaf)[0]):
                    out.update(flax_to_state(
                        _index_tree(value["block"], i),
                        f"{prefix}{layer_name.format(i)}.", scan_name,
                        layer_name))
            else:
                out.update(flax_to_state(value, f"{prefix}{key}.",
                                         scan_name, layer_name))
            continue
        t = tensor({key: value}, key)
        if key == "kernel":
            t = t.T.contiguous()
        out[prefix + _LEAF_NAMES.get(key, key)] = t
    return out


def checkpoint_files(path: str) -> tuple:
    """``(format, files)`` of a checkpoint directory, as the reference's
    HF loaders pick them (``models/llama/convert.py:114-124``,
    ``models/gpt2/convert.py:64-73``): every ``*.safetensors`` if there
    is one, sorted, else every ``pytorch_model*.bin``, sorted. A
    directory with neither raises ``FileNotFoundError`` naming what it
    looked for."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if files:
        return "safetensors", files
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if files:
        return "bin", files
    raise FileNotFoundError(
        f"no weights in {path!r}: looked for *.safetensors and "
        "pytorch_model*.bin")


def read_hf_state(path: str) -> dict:
    """The state dict of an HF checkpoint directory
    (:func:`checkpoint_files`: every ``*.safetensors``, else every
    ``pytorch_model*.bin``); a name in two files takes the later file's
    tensor, as the reference's dict update does."""
    fmt, files = checkpoint_files(path)
    state: dict = {}
    for f in files:
        state.update(iter_safetensors(f) if fmt == "safetensors" else
                     torch.load(f, map_location="cpu", weights_only=True))
    return state


def load_torch_checkpoint(ckpt_dir: str) -> Mapping[str, Any]:
    """The state dict of a checkpoint directory (:328): the first of
    ``pytorch_model.bin``, ``model.ckpt`` and ``last.ckpt`` that exists,
    through ``torch.load(weights_only=True)`` (a Lightning checkpoint
    unwrapped, its ``model.`` prefix stripped), else every
    ``*.safetensors``, sorted, read here. A directory with none of them
    raises ``FileNotFoundError``."""
    for name in ("pytorch_model.bin", "model.ckpt", "last.ckpt"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            state = torch.load(path, map_location="cpu", weights_only=True)
            return state if name == "pytorch_model.bin" else \
                unwrap_lightning(state)
    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if files:
        state: dict = {}
        for f in files:
            state.update(iter_safetensors(f))
        return state
    raise FileNotFoundError(
        f"no pytorch_model.bin / *.safetensors / model.ckpt / last.ckpt "
        f"under {ckpt_dir}")


# -- safetensors ------------------------------------------------------------

#: safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


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


#: torch dtype -> safetensors dtype name
_SAFETENSORS_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` as one safetensors file, tensor by tensor (see
    :func:`write_safetensors_stream`). Returns the bytes written."""
    return write_safetensors_stream(
        path, [(name, t.dtype, t.shape) for name, t in tensors.items()],
        tensors.values())


def write_safetensors_stream(path: str, specs, tensors: Iterable) -> int:
    """Write a safetensors file from ``specs`` (``(name, dtype, shape)``
    in file order) and ``tensors``, an iterable that gives each tensor
    in that order. The header is built from the specs; then each tensor
    is taken from ``tensors``, copied to the host alone and appended,
    so neither a model on the card nor a checkpoint streamed from disk
    passes through host memory whole. A tensor whose dtype or shape
    differs from its spec raises. Returns the bytes written."""
    specs = [(name, dtype, list(shape)) for name, dtype, shape in specs]
    header, offset = {}, 0
    for name, dtype, shape in specs:
        n = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": _SAFETENSORS_NAMES[dtype],
                        "shape": shape,
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for (name, dtype, shape), t in zip(specs, tensors, strict=True):
            if t.dtype != dtype or list(t.shape) != shape:
                raise ValueError(
                    f"{path}: tensor {name!r} is {t.dtype} "
                    f"{list(t.shape)}, its header says {dtype} {shape}")
            if t.numel():
                f.write(memoryview(t.detach().contiguous().cpu().reshape(
                    -1).view(torch.uint8).numpy()))
            del t
    return 8 + len(head) + offset


def check_safetensors_complete(path: str) -> dict:
    """The header of a safetensors file whose size covers every
    tensor's data; a shorter (truncated) file raises ``ValueError``
    before anything is read."""
    header, start = read_safetensors_header(path)
    end = max((info["data_offsets"][1] for k, info in header.items()
               if k != "__metadata__"), default=0)
    if os.path.getsize(path) < start + end:
        raise ValueError(f"{path}: truncated ({os.path.getsize(path)} "
                         f"bytes, header needs {start + end})")
    return header
