"""Startup telemetry (``fengshen_tpu/observability/buildinfo.py``): the
build-info gauge and the warmup-phase gauge in the global registry.

- ``fstpu_build_info{torch_version,cuda_version,device}`` is a constant
  ``1`` info-gauge: the labels are the payload. The reference labels
  its jax version and backend; the port labels the torch build, the
  CUDA toolkit it was built for ("none" on a CPU build) and the device
  name (the card's, or "cpu");
- ``fstpu_warmup_seconds{phase}`` records each warmup phase's wall
  seconds: ``engine`` (every prefill bucket and one decode tick) and
  ``pipeline`` (the simple engine's warmup request).
"""

from __future__ import annotations

from typing import Optional

import torch

from fengshen_tpu_torch.observability.registry import (MetricsRegistry,
                                                       get_registry)

BUILD_INFO_METRIC = "fstpu_build_info"
WARMUP_METRIC = "fstpu_warmup_seconds"


def record_build_info(registry: Optional[MetricsRegistry] = None,
                      device=None) -> None:
    """Set the constant info-gauge for this process's torch build and
    ``device`` (default: the card when one is present)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    reg = registry if registry is not None else get_registry()
    reg.gauge(
        BUILD_INFO_METRIC,
        "constant 1; torch build, CUDA version and device as labels",
        labelnames=("torch_version", "cuda_version", "device"),
    ).labels(torch.__version__, torch.version.cuda or "none", name).set(1)


def record_warmup_seconds(phase: str, seconds: float,
                          registry: Optional[MetricsRegistry] = None
                          ) -> None:
    """Record one warmup phase's wall seconds (gauge: the LAST warmup
    of each phase is the replica's current cold-start cost)."""
    reg = registry if registry is not None else get_registry()
    reg.gauge(
        WARMUP_METRIC,
        "wall seconds of each startup warmup phase",
        labelnames=("phase",),
    ).labels(phase).set(float(seconds))
