"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``cuda``, and with no card present that raises.
The port never quietly moves to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a ``cuda`` device without a card raises
    ``RuntimeError``; anything else is returned as a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fengshen_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on (first parameter)."""
    return next(module.parameters()).device


def check_module_device(module: torch.nn.Module,
                        device: DeviceLike = None) -> torch.device:
    """Resolve ``device`` and require ``module`` to live there, so an
    entry point never runs a CPU model under a cuda request (or the
    reverse) by accident."""
    dev = resolve_device(device)
    have = module_device(module)
    if have.type != dev.type or (
            dev.index is not None and have.index != dev.index):
        raise ValueError(f"model lives on {have}, but device={dev} was "
                         "requested; move the model or pass its device")
    return have
