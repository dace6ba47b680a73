"""Distributed trace context, the part serving reads: the port's copy of
``fengshen_tpu/observability/tracectx.py`` ``TraceContext`` (:77) and
``parse_traceparent`` (:88).

A request that arrives with a W3C-style ``traceparent``
(``00-<32 hex trace id>-<16 hex span id>-<flags>``, as an HTTP header or
a JSON body field) carries its trace id into its timeline, its debug-ring
entry and its response body. The fleet's span ledger and cross-process
trace assembly (the reference's ``SpanLedger``, ``assemble_trace``) are
not yet ported.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

#: the only traceparent version this package emits
TRACEPARENT_VERSION = "00"

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")
_VERSION_RE = re.compile(r"^[0-9a-f]{2}$")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's identity: WHICH trace, and WHO the parent span is."""

    trace_id: str
    span_id: str

    def to_traceparent(self) -> str:
        """The wire form (W3C trace-context header shape)."""
        return f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(value: Any) -> Optional[TraceContext]:
    """Parse a traceparent string; None on anything malformed: an
    unparseable header degrades to "no trace", never to an error on the
    request path."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if version == "ff" or not _VERSION_RE.match(version):
        return None      # ff (and any non-hex) is forbidden by the spec
    if not _TRACE_ID_RE.match(trace_id) or set(trace_id) == {"0"}:
        return None
    if not _SPAN_ID_RE.match(span_id) or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)
