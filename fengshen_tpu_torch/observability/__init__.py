"""Observability for the port's server: metrics registry, Prometheus
exposition, trace spans, request timelines and the flight recorder (the
serving subset of ``fengshen_tpu/observability``, copied, stdlib plus
``torch.profiler`` for span ranges)."""

from fengshen_tpu_torch.observability.buildinfo import (BUILD_INFO_METRIC,
                                                        WARMUP_METRIC,
                                                        record_build_info,
                                                        record_warmup_seconds)
from fengshen_tpu_torch.observability.exposition import (CONTENT_TYPE_LATEST,
                                                         render_prometheus)
from fengshen_tpu_torch.observability.flightrecorder import (
    FlightRecorder, get_flight_recorder)
from fengshen_tpu_torch.observability.registry import (Counter, Gauge,
                                                       Histogram,
                                                       MetricsRegistry,
                                                       get_registry,
                                                       percentile)
from fengshen_tpu_torch.observability.timeline import (PHASE_NAMES,
                                                       RequestTimeline)
from fengshen_tpu_torch.observability.tracectx import (TraceContext,
                                                       parse_traceparent)
from fengshen_tpu_torch.observability.tracing import (current_span_stack,
                                                      span)

__all__ = [
    "BUILD_INFO_METRIC", "CONTENT_TYPE_LATEST", "Counter", "FlightRecorder",
    "Gauge", "Histogram", "MetricsRegistry", "PHASE_NAMES",
    "RequestTimeline", "TraceContext", "WARMUP_METRIC",
    "current_span_stack", "get_flight_recorder", "get_registry",
    "parse_traceparent", "percentile", "record_build_info",
    "record_warmup_seconds", "render_prometheus", "span",
]
