"""Trace spans: named timed sections, profiler-annotated. The port's
copy of ``fengshen_tpu/observability/tracing.py:59 span``.

``span("serving/decode")`` wraps a host-side section. Inside it the
section is a ``torch.profiler.record_function`` range (named on a
``torch.profiler`` trace, where the reference used jax's
``TraceAnnotation``), and its wall time goes into the
``fstpu_span_seconds{span=...}`` histogram of the target registry, so
``/metrics`` carries section timings with no profiler running.

Spans nest: the recorded label is the "/"-joined stack ("fit/step"
inside ``span("fit")`` + ``span("step")``), kept per thread so the
engine thread and the HTTP threads never interleave stacks.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

from fengshen_tpu_torch.observability.registry import (MetricsRegistry,
                                                       get_registry)

SPAN_METRIC = "fstpu_span_seconds"

_local = threading.local()


def current_span_stack() -> tuple:
    """The calling thread's open spans, outermost first."""
    return tuple(getattr(_local, "stack", ()))


@contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None):
    """Time a section and mark it on the profiler's trace."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(name)
    label = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        reg = registry if registry is not None else get_registry()
        reg.histogram(
            SPAN_METRIC,
            "wall seconds spent inside span(), labelled by the nested "
            "span path", labelnames=("span",),
        ).labels(label).observe(dt)
