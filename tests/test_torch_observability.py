"""The port's observability layer (``fengshen_tpu_torch/observability``
and ``serving/metrics.py``) against the JAX package's, on the CPU:

- ``render_prometheus`` text byte for byte after one scripted sequence of
  counter, gauge and histogram operations on both registries, and the
  same percentiles and registration conflicts;
- ``RequestTimeline.to_dict`` and ``phases`` at injected times, the
  event cap included;
- flight-recorder bundles file for file (the injected clock fixes the
  times), a bundle never overwriting an earlier one, and
  ``install_sigterm`` chaining to the previous handler (called directly,
  never through a signal; the handler is restored);
- ``EngineMetrics.snapshot`` with the reference's keys and values;
- spans, trace context and build info.

Every registry and recorder here is the test's own; the one global, the
process recorder of ``get_flight_recorder``, is reset around its test.
"""

import json
import signal

import pytest
import torch

from fengshen_tpu import observability as jax_obs
from fengshen_tpu.serving.metrics import EngineMetrics as JaxEngineMetrics
from fengshen_tpu_torch import observability as obs
from fengshen_tpu_torch.serving.metrics import EngineMetrics


def _script(m):
    """One sequence of operations on a package's observability module;
    returns its registry."""
    reg = m.MetricsRegistry()
    c = reg.counter("fstpu_test_requests_total", "requests\nserved \\ ok",
                    labelnames=("route", "code"))
    c.labels("/api", 200).inc()
    c.labels("/api", 200).inc(2)
    c.labels('/q"x', 503).inc(0.5)
    reg.counter("fstpu_test_plain_total", "plain").inc(7)
    g = reg.gauge("fstpu_test_depth", "depth")
    g.set(3)
    g.inc(2.25)
    g.dec()
    h = reg.histogram("fstpu_test_seconds", "latency",
                      labelnames=("phase",), buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.1, 0.7, 3.0, 1e-9):
        h.labels("decode").observe(v)
    h.labels("prefill").observe(2.0)
    reg.histogram("fstpu_test_ttft_seconds", "ttft").observe(0.3)
    assert reg.counter("fstpu_test_plain_total", "plain").value() == 7
    return reg


def test_render_prometheus_is_byte_equal():
    mine, ref = _script(obs), _script(jax_obs)
    text = obs.render_prometheus(mine)
    assert text == jax_obs.render_prometheus(ref)
    assert 'fstpu_test_requests_total{route="/q\\"x",code="503"} 0.5' in text
    assert obs.render_prometheus(obs.MetricsRegistry()) == ""
    assert obs.CONTENT_TYPE_LATEST == jax_obs.CONTENT_TYPE_LATEST


def test_percentile_and_conflicts_are_the_references():
    for values in ([], [3.0], [5, 1, 4, 2, 3], list(range(100))):
        for q in (0.0, 0.5, 0.95, 1.0):
            assert obs.percentile(values, q) == \
                jax_obs.percentile(values, q)
    for m in (obs, jax_obs):
        reg = m.MetricsRegistry()
        reg.counter("fstpu_x_total", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.gauge("fstpu_x_total")
        with pytest.raises(ValueError):
            reg.counter("fstpu_x_total", labelnames=("b",))
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("fstpu_y_total").inc(-1)


def _timeline(m):
    tl = m.RequestTimeline(10.0, max_events=6, epoch=1234.5)
    tl.trace_id, tl.parent_span_id = "ab" * 16, "cd" * 8
    tl.add(10.0, "enqueued", prompt_tokens=5, bucket=8)
    tl.add(10.25, "admitted", slot=1, bucket=8)
    tl.add(10.25, "prefill_start", bucket=8)
    tl.add(10.5, "first_token")
    for t in (10.75, 11.0, 11.5):
        tl.add(t, "commit", n=1, tick_s=0.125)
    live = tl.phases(now=11.75)
    tl.add(12.0, "finished", reason="length")
    return tl.to_dict(), live, tl.phases(), tl.phases(now=99.0)


def test_request_timeline_is_the_references():
    got = _timeline(obs)
    assert got == _timeline(jax_obs)
    assert obs.PHASE_NAMES == jax_obs.PHASE_NAMES
    d, _, phases, _ = got
    assert d["dropped_events"] == 1
    assert [e["event"] for e in d["events"]][-1] == "finished"
    assert phases == {"queue_wait_s": 0.25, "prefill_s": 0.25,
                      "decode_s": 1.5, "decode_stall_s": 1.125,
                      "total_s": 2.0}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _bundle(m, root):
    """One recorder sequence; returns {bundle: {file: text}} of every
    bundle it wrote."""
    rec = m.FlightRecorder(capacity=4, dump_dir=str(root), clock=_Clock(),
                           snapshot_interval_s=10.0)
    sink = rec.wrap_sink(None)
    for i in range(6):
        sink({"event": "serving_admit", "request_id": f"r{i}"})
    reg = m.MetricsRegistry()
    reg.counter("fstpu_a_total", "a").inc(3)
    reg.histogram("fstpu_b_seconds", "b", labelnames=("k",)).labels(
        "x").observe(0.25)
    assert rec.snapshot_metrics([reg], force=True)
    assert not rec.snapshot_metrics([reg])
    rec.attach("engine", lambda: {"stats": {"completed": 2}, "n": [1, 2]})
    rec.attach("broken", lambda: 1 / 0)
    paths = [rec.dump("on demand!", extra={"why": "test"}),
             rec.dump("engine_tick_error")]
    rec.detach("broken")
    # a second recorder over the same directory (a restarted process)
    # never overwrites the bundles the first one left
    again = m.FlightRecorder(dump_dir=str(root), clock=_Clock())
    paths.append(again.dump("on demand!"))
    return {p.split("/")[-1]: {f.name: f.read_text() for f in
                               sorted((root / p.split("/")[-1]).iterdir())}
            for p in paths}


def test_flight_recorder_bundles_are_the_references(tmp_path):
    got = _bundle(obs, tmp_path / "port")
    assert got == _bundle(jax_obs, tmp_path / "jax")
    assert list(got) == ["dump-0000-on-demand-", "dump-0001-engine_tick_error",
                         "dump-0001-on-demand-"]
    manifest = json.loads(got["dump-0000-on-demand-"]["manifest.json"])
    assert manifest["files"] == ["engine.json", "events.jsonl"]
    assert "ZeroDivisionError" in manifest["provider_errors"]["broken"]
    events = got["dump-0000-on-demand-"]["events.jsonl"].splitlines()
    assert len(events) == 4                 # the ring's capacity
    assert json.loads(events[-1])["event"] == "metrics_snapshot"


def test_install_sigterm_chains_and_restores(tmp_path):
    """The recorder's SIGTERM handler dumps a bundle, then calls the
    previous handler; it is invoked as a function here (no signal is
    sent) and the original disposition is put back."""
    original = signal.getsignal(signal.SIGTERM)
    calls = []
    try:
        signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
        rec = obs.FlightRecorder(dump_dir=str(tmp_path))
        assert rec.install_sigterm()
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    finally:
        signal.signal(signal.SIGTERM, original)
    assert calls == [signal.SIGTERM]
    assert [p.name for p in tmp_path.iterdir()] == ["dump-0000-sigterm"]


def test_get_flight_recorder_honors_its_directory(tmp_path, monkeypatch):
    from fengshen_tpu_torch.observability import flightrecorder
    monkeypatch.setattr(flightrecorder, "_GLOBAL", None)
    monkeypatch.setenv("FSTPU_FLIGHT_DIR", str(tmp_path))
    rec = obs.get_flight_recorder()
    assert rec is obs.get_flight_recorder()
    assert rec.dump_dir == str(tmp_path)


def _engine_metrics(cls):
    m = cls()
    for field in ("admitted", "admitted", "completed", "rejected_draining",
                  "rejected_duplicate", "deferred_admissions"):
        m.count(field)
    m.record_prefill(16)
    m.record_prefill(8)
    m.record_prefill(16)
    m.record_tick(2, 4, 0.25)
    m.record_tick(3, 4, 0.5, tokens=7)
    m.record_spec(8, 3)
    m.record_ttft(0.125)
    m.record_latency(1.5)
    m.record_stream_tokens(5)
    m.record_stream_reconnect()
    m.record_stream_ttfb(0.0625)
    m.record_phases({"queue_wait_s": 0.1, "prefill_s": 0.2,
                     "decode_s": 0.3, "decode_stall_s": 0.05,
                     "total_s": 0.6})
    m.warmup_compile_s = 1.25
    kv = {"layout": "paged", "dtype": "int8", "blocks_total": 9,
          "blocks_used": 4, "blocks_free": 5, "block_tokens": 16,
          "bytes": 4096, "fragmentation": 0.125}
    snap = m.snapshot(queue_depth=1, slots_active=3, num_slots=4, kv=kv,
                      spec={"mode": "prompt_lookup", "gamma": 4},
                      uptime_s=12.3456, last_error=None, draining=True,
                      streams={"active": 2})
    return snap, m.registry


def test_engine_metrics_match_the_references():
    """The same events give the reference's ``/stats`` payload (plus the
    port's ``decode_seconds``) and the same Prometheus samples and types
    (the help texts name the port's decode forward, not a jit)."""
    (snap, reg), (want, jreg) = _engine_metrics(EngineMetrics), \
        _engine_metrics(JaxEngineMetrics)
    assert snap.pop("decode_seconds") == 0.75
    assert snap == want

    def no_help(text):
        return [line for line in text.splitlines()
                if not line.startswith("# HELP")]
    assert no_help(obs.render_prometheus(reg)) == \
        no_help(jax_obs.render_prometheus(jreg))


def test_span_nests_records_and_survives_errors():
    reg = obs.MetricsRegistry()
    with obs.span("serving", registry=reg):
        with obs.span("decode", registry=reg):
            assert obs.current_span_stack() == ("serving", "decode")
    with pytest.raises(RuntimeError):
        with obs.span("boom", registry=reg):
            raise RuntimeError("x")
    assert obs.current_span_stack() == ()
    text = obs.render_prometheus(reg)
    for label in ("serving", "serving/decode", "boom"):
        assert f'fstpu_span_seconds_count{{span="{label}"}} 1' in text


def test_span_marks_the_profiler_trace():
    reg = obs.MetricsRegistry()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("serving/decode", registry=reg):
            torch.ones(4).sum()
    assert "serving/decode" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("value", [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    " 00-" + "AB" * 16 + "-" + "cd" * 8 + "-00 ",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-abc-" + "cd" * 8 + "-01", "garbage", None, 17])
def test_parse_traceparent_is_the_references(value):
    got = obs.parse_traceparent(value)
    want = jax_obs.parse_traceparent(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert got.to_traceparent() == want.to_traceparent()


def test_build_info_names_the_torch_build():
    reg = obs.MetricsRegistry()
    obs.record_build_info(reg, device="cpu")
    obs.record_warmup_seconds("engine", 2.5, registry=reg)
    text = obs.render_prometheus(reg)
    cuda = torch.version.cuda or "none"
    assert (f'fstpu_build_info{{torch_version="{torch.__version__}",'
            f'cuda_version="{cuda}",device="cpu"}} 1') in text
    assert 'fstpu_warmup_seconds{phase="engine"} 2.5' in text
