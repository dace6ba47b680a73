"""The HTTP request telemetry families (``fengshen_tpu/observability/
httpmetrics.py``): the server counts and times its requests into these
global-registry families. Their definitions (name, help, labelnames)
live here once, because the registry's get-or-create matches on the
full signature."""

from __future__ import annotations

from fengshen_tpu_torch.observability.registry import get_registry


def http_requests_total():
    """`fstpu_http_requests_total{route,code}` counter family."""
    return get_registry().counter(
        "fstpu_http_requests_total",
        "REST requests by route and status",
        labelnames=("route", "code"))


def http_request_seconds():
    """`fstpu_http_request_seconds{route}` latency histogram family."""
    return get_registry().histogram(
        "fstpu_http_request_seconds",
        "REST request wall seconds by route",
        labelnames=("route",))
