"""Kernel layer: registry, capability probe and dispatch seam (the
counterpart of ``fengshen_tpu/ops/pallas/__init__.py``).

Every TPU kernel that a ported path runs is a kernel written by hand
for Hopper, in ``fengshen_tpu_torch/csrc`` (built by :mod:`.build`). Each
registers here with its plain PyTorch version:

- :func:`probe` answers "is this a CUDA device of compute capability
  9.x, and is the kernel library built?". It never raises.
- :func:`kernel_choice` picks by where the tensor lies: ``"cuda"`` for a
  CUDA tensor (the wrapper then launches the kernel or raises; there is
  no fallback), ``"plain"`` for a CPU tensor.
- :func:`log_dispatch` states the table once at startup.
- Each :class:`KernelEntry` keeps ``launches``, a plain integer the
  wrapper adds one to where it launches its kernel and nowhere else, so
  a run can show that its main path went through the kernel. A kernel
  with more than one design (K1, K2 and K4: ``"tensor_core"`` for bf16
  inputs, ``"fp32_fma"`` for fp32) also counts its launches per design
  in ``variants``; K3 counts its launches there per query-window length
  (``"s1"``, ``"s5"``, ...). K1 counts its launches given segment ids
  (padded or packed rows) in ``segmented``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Optional

import torch


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch. Never caught to carry
    on: callers fail the work in flight and surface it."""


@dataclasses.dataclass(frozen=True)
class KernelProbe:
    """One answer to "can this device run the port's kernels?"."""

    cuda: bool
    device_name: Optional[str]
    capability: Optional[tuple]
    library_built: bool
    reason: str

    def describe(self) -> dict:
        return {"cuda": self.cuda, "device_name": self.device_name,
                "capability": self.capability,
                "library_built": self.library_built,
                "reason": self.reason}


def probe(device=None) -> KernelProbe:
    """Capability probe for ``device`` (default: the current CUDA
    device). Never raises and never builds anything."""
    from fengshen_tpu_torch.ops.kernels import build

    built = build.library_loaded()
    if not torch.cuda.is_available():
        return KernelProbe(False, None, None, built,
                           "no CUDA device: the plain versions serve "
                           "CPU tensors")
    dev = torch.device("cuda" if device is None else device)
    cap = torch.cuda.get_device_capability(dev)
    name = torch.cuda.get_device_name(dev)
    if cap[0] != 9:
        reason = (f"{name} is sm_{cap[0]}{cap[1]}; the kernels are "
                  "built for sm_90a and CUDA tensors will raise")
    elif not built:
        reason = "Hopper device; the kernel library builds at first use"
    else:
        reason = "Hopper device and kernel library built"
    return KernelProbe(True, name, tuple(cap), built, reason)


@dataclasses.dataclass
class KernelEntry:
    """One hand-written kernel and its plain PyTorch version."""

    name: str
    kernel: Callable
    plain: Callable
    #: the CUDA source in this repository
    source: str
    #: the TPU kernel it replaces (file:line of the ``pl.pallas_call``)
    replaces: str
    #: launches of the kernel itself (the wrapper adds one per launch)
    launches: int = 0
    #: calls that the seam sent to the dense lowering instead
    #: (decode_attention: query windows on the card longer than the
    #: kernel serves, i.e. prefill; block_sparse_attention_fwd:
    #: ``impl="sparse"`` calls with a bias, mask, dropout or segment ids,
    #: or on CPU tensors, as the reference falls back)
    dense_calls: int = 0
    #: launches per design of a kernel that has more than one (K3: per
    #: query-window length)
    variants: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: launches given segment ids (K1: padded and packed rows)
    segmented: int = 0

    def count(self, variant: Optional[str] = None,
              segments: bool = False) -> None:
        """One launch (of the design ``variant``, when it has several;
        ``segments``: with segment ids)."""
        self.launches += 1
        self.segmented += int(segments)
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1


_REGISTRY: Dict[str, KernelEntry] = {}


def register_kernel(name: str, *, kernel: Callable, plain: Callable,
                    source: str, replaces: str) -> KernelEntry:
    entry = KernelEntry(name, kernel, plain, source, replaces)
    _REGISTRY[name] = entry
    return entry


def get_entry(name: str) -> KernelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"no kernel registered under {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def kernel_choice(name: str, tensor: torch.Tensor) -> str:
    """``"cuda"`` for a CUDA tensor, ``"plain"`` for a CPU one. For a
    CUDA tensor this never answers ``"plain"``: the wrapper launches the
    kernel or raises."""
    get_entry(name)
    return "cuda" if tensor.is_cuda else "plain"


def reset_launch_counts() -> None:
    """Set every launch and dense-route count to 0."""
    for entry in _REGISTRY.values():
        entry.launches = 0
        entry.dense_calls = 0
        entry.segmented = 0
        entry.variants.clear()


def log_dispatch(log: Optional[Callable[[dict], None]] = None,
                 device=None) -> Dict[str, str]:
    """State every kernel's dispatch for ``device`` once (structured
    ``log`` when given, stderr otherwise). Returns ``{name: choice}``."""
    dev = torch.device("cpu" if device is None else device)
    info = probe(dev if dev.type == "cuda" else None)
    table = {name: "cuda" if dev.type == "cuda" else "plain"
             for name in sorted(_REGISTRY)}
    if log is not None:
        log({"event": "kernel_dispatch", "device": str(dev),
             "table": table, **info.describe()})
    else:
        summary = " ".join(f"{n}={c}" for n, c in table.items())
        print(f"[fengshen-tpu-torch] kernel dispatch on {dev}: {summary} "
              f"- {info.reason}", file=sys.stderr, flush=True)
    return table


# -- registrations ------------------------------------------------------
# Imported after the seam exists so each kernel module can register
# itself; importing a kernel module builds nothing.

from fengshen_tpu_torch.ops.kernels import block_sparse_attention  # noqa: E402,F401
from fengshen_tpu_torch.ops.kernels import decode_attention  # noqa: E402,F401
from fengshen_tpu_torch.ops.kernels import flash_attention  # noqa: E402,F401
from fengshen_tpu_torch.ops.kernels import fused_ce  # noqa: E402,F401

__all__ = ["KernelError", "KernelProbe", "KernelEntry", "probe",
           "register_kernel", "get_entry", "kernel_choice",
           "reset_launch_counts", "log_dispatch"]
