"""Live token streams between the engine's scheduler thread and the
HTTP worker threads: the port's copy of ``fengshen_tpu/streaming/
stream.py`` (``TokenStream`` :32, ``StreamBook`` :113).

Design constraints, in order:

- the scheduler never blocks on a slow client: `publish`/`sync` only
  append to a list and notify under a per-stream condition; delivery
  happens on the reader's thread;
- readers can (re)enter at ANY index: a `Last-Event-ID` reconnect
  replays from token k out of the stream's own buffer (the
  committed-token list is the replay log, the same journal contract
  `partial()` serves);
- lock order is one-way: engine `_cv` -> `StreamBook._lock` ->
  `TokenStream._cond`. The engine syncs streams while holding its own
  lock, so nothing here calls back into the engine.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterator, Optional

# closed streams kept for late reconnects before eviction; sized like
# the engine's debug ring — enough for any realistic reconnect window,
# bounded so a long-lived server cannot leak one entry per request
_CLOSED_RING = 256


class TokenStream:
    """One request's live token feed.

    The writer (scheduler thread) calls `publish` with the request's
    full committed-token snapshot; the reader iterates `events`, which
    yields each token exactly once from its chosen start index and then
    ONE terminal event. Tokens are append-only: `publish` never
    truncates, so concurrent readers at different offsets stay
    consistent.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._tokens: list = []
        self.finish_reason: Optional[str] = None
        self.evac_target: Optional[str] = None
        self.closed = False

    def publish(self, tokens, finish_reason: Optional[str] = None,
                evac_target: Optional[str] = None) -> int:
        """Append any tokens past the current length, record terminal
        state, wake readers. Returns the number of NEW tokens (0 when
        the snapshot brings nothing — the common non-commit sync)."""
        with self._cond:
            new = len(tokens) - len(self._tokens)
            if new > 0:
                self._tokens.extend(
                    int(t) for t in tokens[len(self._tokens):])
            if evac_target is not None:
                self.evac_target = evac_target
            if finish_reason is not None and not self.closed:
                self.finish_reason = finish_reason
                self.closed = True
            if new > 0 or self.closed:
                self._cond.notify_all()
            return max(new, 0)

    def tokens(self) -> list:
        """Snapshot of the committed tokens so far."""
        with self._cond:
            return list(self._tokens)

    def events(self, start: int = 0,
               timeout: Optional[float] = None) -> Iterator[tuple]:
        """Yield `("token", index, token_id)` for every token at
        index >= start, then exactly one terminal event:

        - `("evacuated", next_index, target)` — the lane moved to
          another replica mid-generation; reconnect THERE with
          `Last-Event-ID = next_index - 1`;
        - `("done", next_index, finish_reason)` — normal end;
        - `("timeout", next_index, None)` — no event within `timeout`
          seconds (the reader's keep-alive/deadline surface; the
          stream itself stays open).

        Tokens are yielded OUTSIDE the condition so a stalled socket
        write never holds the lock against the scheduler's publish.
        """
        pos = max(int(start), 0)
        while True:
            with self._cond:
                while len(self._tokens) <= pos and not self.closed:
                    if not self._cond.wait(timeout=timeout):
                        yield ("timeout", pos, None)
                        return
                batch = self._tokens[pos:]
                closed = self.closed
                reason = self.finish_reason
                target = self.evac_target
            for tok in batch:
                yield ("token", pos, tok)
                pos += 1
            if closed:
                if target is not None and reason in (
                        "evacuated", "handed_off"):
                    yield ("evacuated", pos, target)
                else:
                    yield ("done", pos, reason)
                return


class StreamBook:
    """The engine's registry of live `TokenStream`s, keyed by
    request_id. `sync` is the scheduler-side hot path: when no stream
    was EVER opened it is one attribute read, and per synced request it
    is one dict probe — a non-streaming engine pays nothing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: "OrderedDict[str, TokenStream]" = OrderedDict()
        #: flips true at the first open() and never back — the /stats
        #: gate that keeps never-streaming payloads shape-identical
        self.ever_opened = False

    def open(self, req) -> TokenStream:
        """Get-or-create the stream for `req`, seeded with its current
        committed tokens (so a resumed request's stream starts at k and
        a finished request's stream replays-and-closes). Idempotent —
        the reconnect path lands here too."""
        with self._lock:
            self.ever_opened = True
            stream = self._streams.get(req.request_id)
            if stream is None:
                stream = TokenStream()
                self._streams[req.request_id] = stream
                self._evict_closed_locked()
        self._publish(stream, req)
        return stream

    def sync(self, req) -> int:
        """Scheduler-side push: publish `req`'s committed snapshot to
        its stream if one is open. Returns new-token count (0 on the
        no-stream fast path)."""
        if not self.ever_opened:
            return 0
        with self._lock:
            stream = self._streams.get(req.request_id)
        if stream is None:
            return 0
        return self._publish(stream, req)

    @staticmethod
    def _publish(stream: TokenStream, req) -> int:
        # finish_reason doubles as the terminal marker: the engine sets
        # it exactly once per request (finish/reject/detach), and
        # detach_lane stamps evac_target first, so the terminal event
        # can point the reader at the adopter
        return stream.publish(req.tokens,
                              finish_reason=req.finish_reason,
                              evac_target=req.evac_target)

    def get(self, request_id: str) -> Optional[TokenStream]:
        with self._lock:
            return self._streams.get(request_id)

    def active(self) -> int:
        """Count of open (not yet closed) streams — the
        `fstpu_streams_active` gauge / `/stats streams_active`."""
        with self._lock:
            return sum(1 for s in self._streams.values()
                       if not s.closed)

    def _evict_closed_locked(self) -> None:
        # bound the book: drop the OLDEST CLOSED streams once the
        # closed population outgrows the ring; live streams are never
        # evicted (they are bounded by the engine's slot + queue caps)
        closed = [rid for rid, s in self._streams.items() if s.closed]
        for rid in closed[:max(len(closed) - _CLOSED_RING, 0)]:
            del self._streams[rid]
