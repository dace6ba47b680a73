"""Prometheus text exposition: the port's copy of
``fengshen_tpu/observability/exposition.py:52 render_prometheus``.

``render_prometheus(*registries)`` produces the text format (version
0.0.4); output is byte-deterministic (names, label sets and buckets all
iterate sorted). The serving REST layer (``api/main.py``) mounts it on
its ``GET /metrics`` route. The trainer's standalone exporter thread
(the reference's ``MetricsServer``, :106) is not yet ported.
"""

from __future__ import annotations

from typing import Sequence

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
