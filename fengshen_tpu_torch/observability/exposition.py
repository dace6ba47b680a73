"""Prometheus text exposition: the port's copy of
``fengshen_tpu/observability/exposition.py:52 render_prometheus`` and of
its exporter thread (``MetricsServer`` :106, ``start_metrics_server``
:153).

``render_prometheus(*registries)`` produces the text format (version
0.0.4); output is byte-deterministic (names, label sets and buckets all
iterate sorted). The serving REST layer (``api/main.py``) mounts it on
its ``GET /metrics`` route; the Trainer's ``--metrics_port`` starts
:func:`start_metrics_server`, a daemon ``ThreadingHTTPServer`` serving
``GET /metrics`` and ``/healthz`` for the length of the fit.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from fengshen_tpu_torch.observability.registry import (Counter, Gauge,
                                                       Histogram,
                                                       MetricsRegistry,
                                                       get_registry)

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """Prometheus value formatting: integral values without the
    trailing .0 (so counters read `3`, not `3.0`), floats via repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Sequence[tuple] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Text exposition over one or more registries (the api layer
    concatenates the process-global registry with the engine's own).
    Duplicate names across registries render both blocks; callers keep
    namespaces disjoint (``fstpu_serving_*`` lives only in the engine
    registry)."""
    if not registries:
        registries = (get_registry(),)
    out: list[str] = []
    for reg in registries:
        for metric in reg.metrics():
            out.append(f"# HELP {metric.name} "
                       f"{_escape_help(metric.help)}")
            out.append(f"# TYPE {metric.name} {metric.kind}")
            for label_values, child in metric.children():
                labels = _labelstr(metric.labelnames, label_values)
                if isinstance(metric, (Counter, Gauge)):
                    out.append(f"{metric.name}{labels} {_fmt(child.value)}")
                elif isinstance(metric, Histogram):
                    acc = 0
                    for edge, n in zip(metric.buckets, child.counts):
                        acc += n
                        le = _labelstr(metric.labelnames, label_values,
                                       [("le", _fmt(edge))])
                        out.append(f"{metric.name}_bucket{le} {acc}")
                    acc += child.counts[-1]
                    le = _labelstr(metric.labelnames, label_values,
                                   [("le", "+Inf")])
                    out.append(f"{metric.name}_bucket{le} {acc}")
                    out.append(f"{metric.name}_sum{labels} "
                               f"{_fmt(child.sum)}")
                    out.append(f"{metric.name}_count{labels} {child.count}")
    return "\n".join(out) + "\n" if out else ""


class MetricsServer:
    """Daemon-thread stdlib HTTP exporter for ``GET /metrics``."""

    def __init__(self, host: str, port: int,
                 registries: Sequence[MetricsRegistry]):
        import http.server

        regs = tuple(registries)

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    body = render_prometheus(*regs).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     CONTENT_TYPE_LATEST)
                elif self.path == "/healthz":
                    body = b'{"status": "ok"}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fstpu-metrics-exporter")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


def start_metrics_server(
        port: int, host: str = "0.0.0.0",
        registries: Optional[Sequence[MetricsRegistry]] = None
) -> MetricsServer:
    """Start the exporter thread; ``port=0`` picks a free port
    (``server.port`` has the real one)."""
    return MetricsServer(host, port, registries or (get_registry(),))
