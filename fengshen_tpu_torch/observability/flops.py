"""Model FLOPs per token and the card's peak: the MFU denominator. The
port's copy of ``fengshen_tpu/observability/flops.py``, with a table of
NVIDIA cards in the place of the reference's TPU table.

    mfu = tokens_per_sec * flops_per_token / (peak_per_device * n_devices)

:func:`estimate_flops_per_token` counts the parameter matmul FLOPs of
one token through a dense decoder (x6 for forward and backward, x2 for
inference), excluding attention's O(seq) term, norms and the embedding
lookup: ``mult * (layers * (2h^2 + 2h*kv_dim + 3h*inter) + h*vocab)``.
Under LoRA it still counts the base's weight gradients, which LoRA does
not compute, so its MFU reads high.

The peak is the bf16 dense tensor-core rate from NVIDIA's data sheet
for the device name (``torch.cuda.get_device_name``), the
``FSTPU_PEAK_FLOPS`` override, or a nominal 1 TFLOP/s that keeps MFU
finite on the CPU and is no hardware figure.
"""

from __future__ import annotations

import os
from typing import Any, Optional

#: bf16 dense tensor-core FLOP/s per card (NVIDIA data sheets), keyed by
#: a prefix of ``torch.cuda.get_device_name``; the longest prefix wins
PEAK_FLOPS = {
    "NVIDIA H100": 989e12,          # SXM
    "NVIDIA H100 PCIe": 756e12,
}

#: nominal figure for devices not in the table (CPU runs): finite and
#: comparable run to run on one host, never a hardware claim
NOMINAL_FALLBACK_FLOPS = 1e12

#: env override: FSTPU_PEAK_FLOPS=9.89e14 for an unlisted card
PEAK_FLOPS_ENV = "FSTPU_PEAK_FLOPS"


def peak_flops_per_chip(device_name: Optional[str] = None) -> float:
    """Peak FLOP/s of one device named ``device_name`` (default: CUDA
    device 0's name, or the fallback without a card). Resolution order:
    env override, table (longest prefix), nominal fallback."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        peak = float(env)
        if peak <= 0:
            raise ValueError(f"{PEAK_FLOPS_ENV}={env!r} must be > 0")
        return peak
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else ""
    best = max((k for k in PEAK_FLOPS if device_name.startswith(k)),
               key=len, default=None)
    return PEAK_FLOPS[best] if best else NOMINAL_FALLBACK_FLOPS


def estimate_flops_per_token(config: Any,
                             include_backward: bool = True
                             ) -> Optional[float]:
    """FLOPs one token costs through the dense decoder ``config``
    describes (x6 training, x2 inference); None without
    ``hidden_size`` / ``num_hidden_layers``."""
    h = getattr(config, "hidden_size", None)
    layers = getattr(config, "num_hidden_layers", None)
    if not h or not layers:
        return None
    inter = getattr(config, "intermediate_size", None) or 4 * h
    vocab = getattr(config, "vocab_size", 0) or 0
    heads = getattr(config, "num_attention_heads", None) or 1
    kv_heads = getattr(config, "num_key_value_heads", None) or heads
    head_dim = h // heads
    per_layer = (2 * h * h
                 + 2 * h * (kv_heads * head_dim)
                 + 3 * h * inter)
    mult = 6.0 if include_backward else 2.0
    return mult * (layers * per_layer + h * vocab)
