"""Server-Sent-Events framing: the port's copy of
``fengshen_tpu/streaming/sse.py`` (``format_event`` :24, ``iter_sse``
:36).

The wire contract of ``POST /api/<task>/stream``:

- every `token` event carries `id: <token index>`, so SSE's own
  `Last-Event-ID` reconnect header names the exact resume index;
- `data:` is always one JSON object on one line;
- the stream ends with exactly one terminal event (`done`,
  `evacuated` or `timeout`) and the connection closes.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional


def format_event(event: str, data: dict,
                 event_id: Optional[int] = None) -> bytes:
    """One SSE frame: optional `id:`, `event:`, one-line JSON `data:`,
    blank-line terminator."""
    lines = []
    if event_id is not None:
        lines.append(f"id: {int(event_id)}")
    lines.append(f"event: {event}")
    lines.append("data: " + json.dumps(data, separators=(",", ":")))
    return ("\n".join(lines) + "\n\n").encode("utf-8")


def iter_sse(fp) -> Iterator[dict]:
    """Parse an SSE byte stream (a file-like yielding lines) into
    `{"event": str, "id": Optional[int], "data": dict}` frames.

    Tolerates the parts of the SSE grammar we never emit (comments,
    multi-`data:` frames get concatenated) so a proxy in the middle
    cannot break the router's reader.
    """
    event, event_id, data_parts = None, None, []
    for raw in fp:
        line = raw.decode("utf-8", "replace") if isinstance(raw, bytes) \
            else raw
        line = line.rstrip("\r\n")
        if line == "":
            if event is not None or data_parts:
                payload = "".join(data_parts)
                try:
                    data = json.loads(payload) if payload else {}
                except ValueError:
                    data = {"raw": payload}
                yield {"event": event or "message", "id": event_id,
                       "data": data}
            event, event_id, data_parts = None, None, []
            continue
        if line.startswith(":"):        # comment / keep-alive
            continue
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "event":
            event = value
        elif field == "data":
            data_parts.append(value)
        elif field == "id":
            try:
                event_id = int(value)
            except ValueError:
                event_id = None
    if event is not None or data_parts:
        payload = "".join(data_parts)
        try:
            data = json.loads(payload) if payload else {}
        except ValueError:
            data = {"raw": payload}
        yield {"event": event or "message", "id": event_id,
               "data": data}
