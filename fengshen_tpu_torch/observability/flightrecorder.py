"""Flight recorder: a bounded in-memory ring of recent structured
events and rate-limited metric snapshots, dumped as a deterministic
post-mortem bundle. The port's copy of
``fengshen_tpu/observability/flightrecorder.py`` (``FlightRecorder``
:53, ``get_flight_recorder`` :218).

It writes a bundle on an engine tick error (the engine's serve loop),
on the server's SIGTERM drain, on ``install_sigterm``'s chained handler,
and on demand (``POST /debug/dump``).

Bundle layout (everything json, `sort_keys=True`, dump sequence numbers
instead of wall-clock in file names):

    <dump_dir>/dump-<seq>-<reason>/
        manifest.json     reason, extra, file list, provider errors
        events.jsonl      the ring, oldest first, t_s relative to start
        <provider>.json   one file per attached provider (the engine
                          contributes stats, config and the last
                          request timelines)

A dump never fails its trigger: provider exceptions are recorded in the
manifest instead of raised. A bundle never overwrites an earlier one,
not even one an earlier process left in the same directory. Pure
stdlib; the clock is injectable for deterministic tests.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional

#: default ring capacity (events); at serving rates this is minutes of
#: lifecycle events, at trainer rates many log windows
DEFAULT_CAPACITY = 512

#: default minimum seconds between two recorded metric snapshots
DEFAULT_SNAPSHOT_INTERVAL_S = 10.0


class FlightRecorder:
    """Bounded event ring + provider registry + post-mortem dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: str = "fstpu_dumps",
                 clock: Callable[[], float] = time.monotonic,
                 snapshot_interval_s: float = DEFAULT_SNAPSHOT_INTERVAL_S):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.snapshot_interval_s = float(snapshot_interval_s)
        self._clock = clock
        self._t0 = clock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._dump_seq = 0
        self._last_snapshot: Optional[float] = None

    # -- feed ---------------------------------------------------------
    def record(self, entry: dict) -> None:
        """Append one structured event to the ring (thread-safe)."""
        stamped = {"t_s": round(self._clock() - self._t0, 6), **entry}
        with self._lock:
            self._ring.append(stamped)

    def wrap_sink(self, sink: Optional[Callable[[dict], None]] = None
                  ) -> Callable[[dict], None]:
        """A sink callable that records into the ring, then forwards to
        `sink` — drop-in for any `log=`/`JsonlSink` slot."""
        def recording_sink(entry: dict) -> None:
            self.record(entry)
            if sink is not None:
                sink(entry)
        return recording_sink

    def snapshot_metrics(self, registries: Iterable, *,
                         force: bool = False) -> bool:
        """Record a compact {metric: value} snapshot of `registries`
        into the ring, rate-limited to one per `snapshot_interval_s`
        unless `force`. Counters/gauges store their value; histograms
        their (count, sum). Returns whether a snapshot was recorded."""
        now = self._clock()
        with self._lock:
            if not force and self._last_snapshot is not None and \
                    now - self._last_snapshot < self.snapshot_interval_s:
                return False
            self._last_snapshot = now
        snap: Dict[str, object] = {}
        for registry in registries:
            for metric in registry.metrics():
                for values, child in metric.children():
                    key = metric.name if not values else \
                        metric.name + "{" + ",".join(values) + "}"
                    if hasattr(child, "value"):
                        snap[key] = child.value
                    else:   # histogram child
                        snap[key] = {"count": child.count,
                                     "sum": round(child.sum, 6)}
        self.record({"event": "metrics_snapshot", "metrics": snap})
        return True

    # -- providers ----------------------------------------------------
    def attach(self, name: str, provider: Callable[[], dict]) -> None:
        """Register `provider` (a zero-arg callable returning a JSON-able
        dict) to contribute `<name>.json` to every future dump; an
        existing provider under the same name is replaced."""
        with self._lock:
            self._providers[name] = provider

    def detach(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- dump ---------------------------------------------------------
    def dump(self, reason: str, extra: Optional[dict] = None,
             dump_dir: Optional[str] = None) -> str:
        """Write the post-mortem bundle; returns its directory path.
        Provider failures land in the manifest, never raise."""
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason) or "dump"
        root = dump_dir or self.dump_dir
        with self._lock:
            ring = list(self._ring)
            providers = dict(self._providers)
            # skip past bundles an EARLIER process left behind: a
            # crash-restart-crash loop must keep every post-mortem,
            # not overwrite dump-0000-<reason> each time
            while True:
                bundle = os.path.join(
                    root, f"dump-{self._dump_seq:04d}-{safe}")
                self._dump_seq += 1
                if not os.path.isdir(bundle):
                    break
        os.makedirs(bundle, exist_ok=True)
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            for entry in ring:
                f.write(json.dumps(entry, sort_keys=True, default=str)
                        + "\n")
        files = ["events.jsonl"]
        errors: Dict[str, str] = {}
        for name in sorted(providers):
            try:
                payload = providers[name]()
            except Exception as e:  # noqa: BLE001 — a post-mortem dump
                # must capture what it can and never fail its trigger
                errors[name] = f"{type(e).__name__}: {str(e)[:200]}"
                continue
            fname = f"{name}.json"
            with open(os.path.join(bundle, fname), "w") as f:
                json.dump(payload, f, sort_keys=True, indent=1,
                          default=str)
            files.append(fname)
        manifest = {
            "schema": 1,
            "reason": reason,
            "extra": extra or {},
            "events": len(ring),
            "files": sorted(files),
            "provider_errors": errors,
        }
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f, sort_keys=True, indent=1, default=str)
        return bundle

    # -- signal wiring ------------------------------------------------
    def install_sigterm(self) -> bool:
        """Chain a SIGTERM handler that dumps a bundle before delegating
        to the PREVIOUS handler (an outer launcher's handler keeps
        working). The previous disposition SIG_DFL is re-delivered, so
        the process still terminates. Returns False off the main thread
        or where signals are unavailable."""
        import signal
        if threading.current_thread() is not threading.main_thread():
            return False
        previous = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            try:
                self.dump(reason="sigterm")
            except Exception:  # noqa: BLE001 — the dump must never
                # block the process's normal termination path
                pass
            if callable(previous):
                previous(signum, frame)
            elif previous != signal.SIG_IGN:
                # SIG_DFL, or None (a handler installed from C that we
                # cannot call OR restore) — re-deliver through the
                # default disposition so the process still TERMINATES:
                # a dump must never turn SIGTERM into a no-op. SIG_IGN
                # alone is honored by doing nothing, matching the
                # previous disposition.
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        try:
            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            return False
        return True


_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global recorder (ad-hoc embedders); the dump
    directory honors FSTPU_FLIGHT_DIR. Servers build their OWN
    recorders so concurrent engines never share a ring."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = FlightRecorder(
                dump_dir=os.environ.get("FSTPU_FLIGHT_DIR",
                                        "fstpu_dumps"))
        return _GLOBAL
