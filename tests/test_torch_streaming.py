"""The port's streaming tier (``fengshen_tpu_torch/streaming``) against
the JAX package's (``fengshen_tpu/streaming``), on the CPU: the SSE
frames byte for byte, ``iter_sse`` on the same bytes (comments, data
split over lines, CRLF, a frame cut by EOF, bad JSON and ids), and
``TokenStream`` / ``StreamBook`` events for the same publish sequences.
Neither module imports JAX; the comparison is of the two copies."""

import threading

import pytest

from fengshen_tpu.streaming import StreamBook as JaxStreamBook
from fengshen_tpu.streaming import TokenStream as JaxTokenStream
from fengshen_tpu.streaming import format_event as jax_format_event
from fengshen_tpu.streaming import iter_sse as jax_iter_sse
from fengshen_tpu_torch.streaming import (StreamBook, TokenStream,
                                          format_event, iter_sse)

EVENTS = [("token", {"token": 42}, 0), ("token", {"token": 7}, 1),
          ("done", {"request_id": "r", "finish_reason": "length",
                    "result": "今天 7 42"}, 2),
          ("timeout", {"request_id": "r", "error": "no event"}, None),
          ("evacuated", {"request_id": "r", "target": "http://a:1"}, 5)]

#: a byte stream with what a proxy may add: comments, a keep-alive,
#: ``data:`` split over lines, CRLF endings, a frame without ``event:``,
#: bad JSON, a bad id, and a last frame cut by EOF
RAW = (b": keep-alive\n\n"
       b"id: 3\nevent: token\ndata: {\"to\ndata: ken\": 1}\n\n"
       b"id: 4\r\nevent: token\r\ndata: {\"token\": 2}\r\n\r\n"
       b"data: {\"bare\": true}\n\n"
       b"event: oops\ndata: not json\n\n"
       b"id: x\nevent: token\ndata: {}\n\n"
       b"id: 9\nevent: done\ndata: {\"finish_reason\": \"eos\"}")


@pytest.mark.parametrize("event,data,event_id", EVENTS)
def test_format_event_is_byte_equal(event, data, event_id):
    assert format_event(event, data, event_id) == \
        jax_format_event(event, data, event_id)


def test_iter_sse_parses_the_same_frames():
    lines = RAW.splitlines(keepends=True)
    got = list(iter_sse(lines))
    assert got == list(jax_iter_sse(lines))
    assert got == list(iter_sse(RAW.decode().splitlines()))
    assert [(f["event"], f["id"]) for f in got] == [
        ("token", 3), ("token", 4), ("message", None), ("oops", None),
        ("token", None), ("done", 9)]
    assert got[0]["data"] == {"token": 1}
    assert got[3]["data"] == {"raw": "not json"}
    wire = b"".join(format_event(e, d, i) for e, d, i in EVENTS)
    frames = list(iter_sse(wire.splitlines(keepends=True)))
    assert frames == list(jax_iter_sse(wire.splitlines(keepends=True)))
    assert [(f["event"], f["data"], f["id"]) for f in frames] == EVENTS


def _stream_script(cls):
    """The same publish sequence and readers on either TokenStream."""
    s = cls()
    out = [s.publish([5, 6]), s.publish([5, 6]),
           list(s.events(0, timeout=0.01))]
    out.append(s.publish([5, 6, 7, 8]))
    out.append(list(s.events(3, timeout=0.01)))
    out.append(s.publish([5, 6, 7, 8, 9], finish_reason="length"))
    out.append(s.publish([5, 6, 7, 8, 9, 10], finish_reason="eos"))
    out += [list(s.events(k, timeout=1.0)) for k in (0, 2, 5, 9)]
    out += [s.tokens(), s.finish_reason, s.closed]
    evac = cls()
    evac.publish([1], evac_target="http://peer:8000")
    evac.publish([1, 2], finish_reason="evacuated")
    out.append(list(evac.events(0, timeout=1.0)))
    return out


def test_token_stream_events_are_equal():
    got = _stream_script(TokenStream)
    assert got == _stream_script(JaxTokenStream)
    assert got[2] == [("token", 0, 5), ("token", 1, 6),
                      ("timeout", 2, None)]
    # a closed stream keeps its first finish reason; tokens published
    # after it still append (the reference's behaviour)
    assert got[7] == [("token", 0, 5), ("token", 1, 6), ("token", 2, 7),
                      ("token", 3, 8), ("token", 4, 9), ("token", 5, 10),
                      ("done", 6, "length")]


def test_token_stream_wakes_a_live_reader():
    """A reader blocked at the stream's end gets each token as the
    writer publishes it, then the terminal event."""
    s = TokenStream()
    seen = []
    reader = threading.Thread(
        target=lambda: seen.extend(s.events(0, timeout=10)))
    reader.start()
    for n in range(1, 4):
        s.publish(list(range(n)))
    s.publish([0, 1, 2], finish_reason="eos")
    reader.join(timeout=10)
    assert seen == [("token", 0, 0), ("token", 1, 1), ("token", 2, 2),
                    ("done", 3, "eos")]


class _Req:
    """What a StreamBook reads of an engine request."""

    def __init__(self, request_id):
        self.request_id = request_id
        self.tokens = []
        self.finish_reason = None
        self.evac_target = None


def _book_script(cls, ring):
    book = cls()
    out = [book.ever_opened, book.sync(_Req("none"))]
    reqs = [_Req(f"r{i}") for i in range(ring + 3)]
    reqs[0].tokens = [4, 5]
    stream = book.open(reqs[0])
    out += [book.ever_opened, stream.tokens(), book.open(reqs[0]) is stream]
    reqs[0].tokens.append(6)
    out += [book.sync(reqs[0]), book.sync(reqs[0]), book.active()]
    reqs[0].finish_reason = "length"
    out += [book.sync(reqs[0]), book.active(),
            list(book.get("r0").events(1, timeout=1.0))]
    for req in reqs[1:]:
        book.open(req)
        req.finish_reason = "eos"
        book.sync(req)
    # closed streams beyond the ring are evicted, oldest first
    out.append([r.request_id for r in reqs
                if book.get(r.request_id) is not None])
    return out


def test_stream_book_is_the_references():
    from fengshen_tpu.streaming import stream as jax_stream
    from fengshen_tpu_torch.streaming import stream
    assert stream._CLOSED_RING == jax_stream._CLOSED_RING
    got = _book_script(StreamBook, stream._CLOSED_RING)
    assert got == _book_script(JaxStreamBook, jax_stream._CLOSED_RING)
    assert got[:2] == [False, 0]
    assert got[-1][0] == "r2"
