"""Step statistics for the Trainer: tokens/s, MFU and goodput. The
port's copy of ``fengshen_tpu/observability/stepstats.py``.

The Trainer feeds one :meth:`StepStats.record_execution` per step and
closes a window at each log line (:meth:`window_entry`); rewinds and the
guards' cumulative ``bad_step_count`` feed goodput. Each value lands in
the returned dict (merged into the ``metrics.jsonl`` step entry) and in
the registry's ``fstpu_train_*`` gauges for ``/metrics``.

- ``tokens_per_sec``: tokens consumed over the wall-clock window since
  the last log line (data loading included).
- ``mfu``: ``tokens_per_sec * flops_per_token / (peak * n_devices)``,
  the peak from :mod:`.flops`.
- ``goodput``: productive over attempted steps, cumulative: attempted =
  ``global_step`` + steps replayed by rewinds, productive =
  ``global_step`` - guarded-away steps.
"""

from __future__ import annotations

import time
from typing import Optional

from fengshen_tpu_torch.observability.flops import peak_flops_per_chip
from fengshen_tpu_torch.observability.registry import (MetricsRegistry,
                                                       get_registry)


class StepStats:
    def __init__(self, flops_per_token: float, n_devices: int,
                 device_kind: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter):
        self.flops_per_token = float(flops_per_token)
        self.peak_total = peak_flops_per_chip(device_kind) * max(
            int(n_devices), 1)
        self._clock = clock
        self._window_start = clock()
        self._window_tokens = 0
        self._window_steps = 0
        self._replayed_steps = 0
        reg = registry if registry is not None else get_registry()
        self._g_step = reg.gauge(
            "fstpu_train_step", "current global step")
        self._g_tps = reg.gauge(
            "fstpu_train_tokens_per_sec",
            "tokens/s over the last log window")
        self._g_mfu = reg.gauge(
            "fstpu_train_mfu",
            "model-FLOPs-utilization over the last log window")
        self._g_goodput = reg.gauge(
            "fstpu_train_goodput",
            "cumulative productive/attempted step ratio")
        self._g_bad = reg.gauge(
            "fstpu_train_bad_steps_total",
            "cumulative steps skipped by the step guards")
        self._c_rewinds = reg.counter(
            "fstpu_train_rewinds_total",
            "rewind-on-divergence restores this run")
        self._c_tokens = reg.counter(
            "fstpu_train_tokens_total", "tokens consumed this run")

    def record_execution(self, n_steps: int, n_tokens: int) -> None:
        self._window_steps += int(n_steps)
        self._window_tokens += int(n_tokens)
        self._c_tokens.inc(int(n_tokens))

    def record_rewind(self, from_step: int, to_step: int) -> None:
        """A rewind replays [to_step, from_step): those steps count
        against goodput's attempted steps."""
        self._replayed_steps += max(int(from_step) - int(to_step), 0)
        self._c_rewinds.inc()

    def goodput(self, global_step: int, bad_step_count: int) -> float:
        attempted = int(global_step) + self._replayed_steps
        if attempted <= 0:
            return 1.0
        productive = max(int(global_step) - int(bad_step_count), 0)
        return productive / attempted

    def window_entry(self, global_step: int,
                     bad_step_count: int = 0) -> dict:
        """Close the window: publish and return ``tokens_per_sec``,
        ``mfu`` and ``goodput``, and start the next window."""
        now = self._clock()
        dt = now - self._window_start
        tps = self._window_tokens / dt if dt > 0 else 0.0
        mfu = tps * self.flops_per_token / self.peak_total
        goodput = self.goodput(global_step, bad_step_count)
        self._g_step.set(int(global_step))
        self._g_tps.set(tps)
        self._g_mfu.set(mfu)
        self._g_goodput.set(goodput)
        self._g_bad.set(int(bad_step_count))
        self._window_start = now
        self._window_tokens = 0
        self._window_steps = 0
        return {"tokens_per_sec": tps, "mfu": mfu, "goodput": goodput}
