"""Observability for the port's server and trainer: metrics registry,
Prometheus exposition and the exporter thread, trace spans, request
timelines, the flight recorder, the jsonl event sink, step statistics
(tokens/s, MFU, goodput) and the FLOPs estimator (the port's copy of
``fengshen_tpu/observability``: stdlib plus ``torch.profiler`` for span
ranges)."""

from fengshen_tpu_torch.observability.buildinfo import (BUILD_INFO_METRIC,
                                                        WARMUP_METRIC,
                                                        record_build_info,
                                                        record_warmup_seconds)
from fengshen_tpu_torch.observability.exposition import (CONTENT_TYPE_LATEST,
                                                         MetricsServer,
                                                         render_prometheus,
                                                         start_metrics_server)
from fengshen_tpu_torch.observability.flops import (estimate_flops_per_token,
                                                    peak_flops_per_chip)
from fengshen_tpu_torch.observability.flightrecorder import (
    FlightRecorder, get_flight_recorder)
from fengshen_tpu_torch.observability.registry import (Counter, Gauge,
                                                       Histogram,
                                                       MetricsRegistry,
                                                       get_registry,
                                                       percentile)
from fengshen_tpu_torch.observability.sink import JsonlSink
from fengshen_tpu_torch.observability.stepstats import StepStats
from fengshen_tpu_torch.observability.timeline import (PHASE_NAMES,
                                                       RequestTimeline)
from fengshen_tpu_torch.observability.tracectx import (TraceContext,
                                                       parse_traceparent)
from fengshen_tpu_torch.observability.tracing import (current_span_stack,
                                                      span)

__all__ = [
    "BUILD_INFO_METRIC", "CONTENT_TYPE_LATEST", "Counter", "FlightRecorder",
    "Gauge", "Histogram", "JsonlSink", "MetricsRegistry", "MetricsServer",
    "PHASE_NAMES", "RequestTimeline", "StepStats", "TraceContext",
    "WARMUP_METRIC", "current_span_stack", "estimate_flops_per_token",
    "get_flight_recorder", "get_registry", "parse_traceparent",
    "peak_flops_per_chip", "percentile", "record_build_info",
    "record_warmup_seconds", "render_prometheus", "span",
    "start_metrics_server",
]
