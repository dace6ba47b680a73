"""Per-request lifecycle timelines: the port's copy of
``fengshen_tpu/observability/timeline.py`` (``RequestTimeline`` :56,
``PHASE_NAMES`` :50).

A `RequestTimeline` is a bounded host-side list of timestamped
lifecycle events for ONE serving request (enqueued, admitted,
prefill_start, first_token, per-tick commits, terminal state). The
engine appends them on its scheduler thread between forwards; nothing
here touches the device.

`phases()` derives the latency waterfall the debug endpoints and the
`fstpu_request_phase_seconds{phase}` histograms expose:

- ``queue_wait_s``: submit -> prefill_start (admission wait and any
  paged block-exhaustion deferral);
- ``prefill_s``: prefill_start -> first_token (the bucketed prefill);
- ``decode_s``: first_token -> terminal;
- ``decode_stall_s``: decode_s minus the wall time of the ticks that
  committed tokens to this request (time the request sat in a lane
  while the engine was not in its decode forward).

The first three phases telescope: their sum equals ``total_s`` (the
submit -> terminal wall clock). Missing marks (a request rejected or
cancelled before admission) read 0 and queue_wait absorbs the whole
latency. Timestamps come from the caller's clock (the engine's
injectable monotonic clock), so tests drive deterministic waterfalls.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

#: terminal lifecycle event names (mirror serving.engine's states);
#: "evacuated" is the reference's live-evacuation end mark, kept so the
#: two packages' timelines read alike
TERMINAL_EVENTS = ("finished", "cancelled", "expired", "rejected",
                   "evacuated")

#: the derived waterfall phases, in lifecycle order
PHASE_NAMES = ("queue_wait_s", "prefill_s", "decode_s")

#: per-request event cap: a long generation commits one event per tick,
#: so the cap bounds memory without losing the lifecycle marks (which
#: all land before the commit stream)
DEFAULT_MAX_EVENTS = 512


class RequestTimeline:
    """Bounded timestamped event list for one request's lifecycle."""

    __slots__ = ("t0", "events", "dropped", "dropped_tick_s",
                 "max_events", "trace_id", "parent_span_id",
                 "epoch_unix_s")

    def __init__(self, t0: float, max_events: int = DEFAULT_MAX_EVENTS,
                 epoch: Optional[float] = None):
        self.t0 = float(t0)
        #: (seconds since t0, event name, attrs dict or None)
        self.events: List[Tuple[float, str, Optional[dict]]] = []
        self.dropped = 0
        #: tick wall time carried by dropped commit events — kept so a
        #: capped timeline's decode_stall_s stays honest
        self.dropped_tick_s = 0.0
        self.max_events = int(max_events)
        #: distributed-trace correlation: set by the submitter when the
        #: request arrived with a traceparent; None otherwise
        self.trace_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None
        #: wall-clock anchor for the monotonic t0
        self.epoch_unix_s = round(
            time.time() if epoch is None else float(epoch), 6)

    def add(self, t: float, event: str, **attrs) -> None:
        """Append one event at absolute clock time `t`; counts (instead
        of stores) NON-terminal events past the cap so a pathological
        generation cannot grow host memory unboundedly. Terminal events
        always land (at most one fires per request), so a capped
        timeline still carries its end mark and `phases()` stays
        end-anchored."""
        if event not in TERMINAL_EVENTS and \
                len(self.events) >= self.max_events:
            self.dropped += 1
            self.dropped_tick_s += float(attrs.get("tick_s", 0.0))
            return
        self.events.append((round(t - self.t0, 6), event,
                            attrs if attrs else None))

    def mark(self, event: str) -> Optional[float]:
        """Relative time of the FIRST occurrence of `event`, or None."""
        for t, name, _ in self.events:
            if name == event:
                return t
        return None

    def end_mark(self) -> Optional[float]:
        """Relative time of the terminal event, if one was recorded."""
        for t, name, _ in reversed(self.events):
            if name in TERMINAL_EVENTS:
                return t
        return None

    def phases(self, now: Optional[float] = None) -> dict:
        """The latency waterfall. `now` (absolute clock) bounds a
        still-live request; a finished one uses its terminal event.
        queue_wait + prefill + decode == total exactly (up to the 6-dp
        rounding of each term)."""
        end = self.end_mark()
        if end is None:
            end = (now - self.t0) if now is not None else (
                self.events[-1][0] if self.events else 0.0)
        prefill_start = self.mark("prefill_start")
        first_token = self.mark("first_token")
        ps = end if prefill_start is None else min(prefill_start, end)
        ft = ps if first_token is None else min(max(first_token, ps), end)
        tick_s = self.dropped_tick_s + \
            sum((attrs or {}).get("tick_s", 0.0)
                for _, name, attrs in self.events
                if name == "commit")
        decode = max(end - ft, 0.0)
        return {
            "queue_wait_s": round(max(ps, 0.0), 6),
            "prefill_s": round(max(ft - ps, 0.0), 6),
            "decode_s": round(decode, 6),
            "decode_stall_s": round(max(decode - tick_s, 0.0), 6),
            "total_s": round(max(end, 0.0), 6),
        }

    def to_dict(self) -> dict:
        """JSON-ready event list (times relative to submit)."""
        events = []
        for t, name, attrs in self.events:
            e = {"t_s": t, "event": name}
            if attrs:
                e.update(attrs)
            events.append(e)
        return {"events": events, "dropped_events": self.dropped,
                "trace_id": self.trace_id,
                "parent_span_id": self.parent_span_id,
                "epoch_unix_s": self.epoch_unix_s}
