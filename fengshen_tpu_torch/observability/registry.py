"""Process-local metrics registry: counters, gauges, histograms. The
port's own copy of ``fengshen_tpu/observability/registry.py`` (pure
stdlib).

The serving engine's metrics (``serving.metrics.EngineMetrics``), the
HTTP counters and the span timer record here; the Prometheus
renderer (:func:`.exposition.render_prometheus`) and the ``/stats``
JSON read from it.

Conventions (the reference's):

- metric names follow Prometheus rules (``fstpu_<subsystem>_<what>[_total]``)
  and are validated at creation;
- ``counter()/gauge()/histogram()`` are get-or-create: asking twice for
  the same name returns the SAME object, and asking for the same name
  with a different type or label set raises;
- every iteration (names, label sets, buckets) is sorted, so rendering
  and snapshots are byte-deterministic.
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Prometheus' default histogram buckets (seconds-flavored)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: bounded sample window kept per histogram child for percentile queries
DEFAULT_WINDOW = 512


def percentile(values: Iterable[float], q: float) -> float:
    """THE percentile implementation (sorted nearest-rank-below).

    ``idx = min(int(q * n), n - 1)`` over the sorted window, as the
    reference's ``/stats`` computes it; ``Histogram.percentile`` and
    every adapter call through here. Returns 0.0 for an empty input.
    """
    vals = sorted(values)
    if not vals:
        return 0.0
    idx = min(int(q * len(vals)), len(vals) - 1)
    return float(vals[idx])


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0


class _CounterChild(_Child):
    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc({n}))")
        with self._lock:
            self.value += n


class _GaugeChild(_Child):
    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self.value -= n


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "window")

    def __init__(self, lock: threading.Lock, buckets: Tuple[float, ...],
                 window: int):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0
        self.window = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            self.window.append(v)
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1

    # -- window queries (the /stats percentile surface) ---------------
    def window_values(self) -> List[float]:
        with self._lock:
            return list(self.window)

    def percentile(self, q: float) -> float:
        return percentile(self.window_values(), q)

    def window_avg(self) -> float:
        vals = self.window_values()
        return sum(vals) / len(vals) if vals else 0.0


class Metric:
    """Base: a named family of children keyed by label values.

    Unlabelled metrics have exactly one child (label key ``()``) and
    proxy the mutators directly; labelled ones hand out children via
    ``labels(...)``.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values) -> object:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(values)}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _only_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labelled {self.labelnames}; call "
                ".labels(...) first")
        return self._children[()]

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        """(label values, child) pairs, sorted for determinism."""
        with self._lock:
            return sorted(self._children.items())

    def signature(self) -> Tuple[str, Tuple[str, ...]]:
        return (self.kind, self.labelnames)


class Counter(Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, n: float = 1) -> None:
        self._only_child().inc(n)

    def value(self) -> float:
        return self._only_child().value


class Gauge(Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, v: float) -> None:
        self._only_child().set(v)

    def inc(self, n: float = 1) -> None:
        self._only_child().inc(n)

    def dec(self, n: float = 1) -> None:
        self._only_child().dec(n)

    def value(self) -> float:
        return self._only_child().value


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = DEFAULT_WINDOW):
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(not math.isfinite(x) for x in b):
            raise ValueError(f"bad histogram buckets {buckets!r}")
        self.buckets = b
        self.window_size = int(window)
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets, self.window_size)

    def observe(self, v: float) -> None:
        self._only_child().observe(v)

    def percentile(self, q: float) -> float:
        return self._only_child().percentile(q)

    def window_values(self) -> List[float]:
        return self._only_child().window_values()

    def window_avg(self) -> float:
        return self._only_child().window_avg()

    def signature(self):
        return (self.kind, self.labelnames, self.buckets,
                self.window_size)


class MetricsRegistry:
    """Get-or-create home for a process's (or one engine's) metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        candidate = cls(name, help, **kw)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is None:
                self._metrics[name] = candidate
                return candidate
            if existing.signature() != candidate.signature():
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.signature()}, asked for "
                    f"{candidate.signature()}")
            return existing

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help,
                                   labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help,
                                   labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   labelnames=labelnames,
                                   buckets=buckets, window=window)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        """All metrics, sorted by name (deterministic exposition)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]


#: the process-global registry (span timer, HTTP counters, build info);
#: per-engine registries exist alongside it so concurrent engines never
#: cross-contaminate their `/stats` counts
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL
