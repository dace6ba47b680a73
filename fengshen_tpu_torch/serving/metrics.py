"""Engine-level serving metrics: the ``/stats`` subset of
``fengshen_tpu/serving/metrics.py``, as plain thread-safe counters (the
reference's Prometheus registry is not ported)."""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

COUNTERS = ("admitted", "rejected_queue_full", "rejected_prompt_too_long",
            "completed", "cancelled", "expired", "deferred_admissions")


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile (0 for no values)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, int(round(
        q * (len(ordered) - 1)))))]


class EngineMetrics:
    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._prefills: dict[int, int] = {}
        self._ticks = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._occupied = 0
        self._lane_ticks = 0
        self._peak_active = 0
        self._ttft: deque = deque(maxlen=window)
        self._latency: deque = deque(maxlen=window)
        self.warmup_s: Optional[float] = None

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n

    def record_prefill(self, bucket: int) -> None:
        with self._lock:
            self._prefills[bucket] = self._prefills.get(bucket, 0) + 1

    def record_tick(self, n_active: int, num_slots: int,
                    seconds: float) -> None:
        with self._lock:
            self._ticks += 1
            self._decode_tokens += n_active
            self._decode_s += seconds
            self._occupied += n_active
            self._lane_ticks += num_slots
            self._peak_active = max(self._peak_active, n_active)

    def record_ttft(self, seconds: float) -> None:
        with self._lock:
            self._ttft.append(seconds)

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.append(seconds)

    def snapshot(self, **extra) -> dict:
        """The ``/stats`` payload; ``extra`` (queue depth, pool state)
        comes from the engine."""
        with self._lock:
            ttft = list(self._ttft)
            out = dict(self._counts)
            out.update(
                prefills_per_bucket=dict(sorted(self._prefills.items())),
                decode_ticks=self._ticks,
                decode_tokens=self._decode_tokens,
                decode_seconds=self._decode_s,
                decode_tokens_per_sec=(self._decode_tokens / self._decode_s
                                       if self._decode_s > 0 else 0.0),
                slot_occupancy=(self._occupied / self._lane_ticks
                                if self._lane_ticks else 0.0),
                slots_active_peak=self._peak_active,
                ttft_avg_s=sum(ttft) / len(ttft) if ttft else 0.0,
                ttft_p50_s=_percentile(ttft, 0.5),
                ttft_p95_s=_percentile(ttft, 0.95),
                latency_p50_s=_percentile(list(self._latency), 0.5),
                warmup_s=self.warmup_s)
        out.update(extra)
        return out
