"""REST serving: the stdlib server of ``fengshen_tpu/api/main.py``.

A JSON config names the server options (SERVER), engine overrides
(ENGINE, ``serving.EngineConfig`` fields) and the pipeline (PIPELINE:
``model`` is an HF LLaMA checkpoint directory, every other key a
``Pipeline`` argument, ``seed`` the sampling seed)::

    python -m fengshen_tpu_torch.api.main --config server.json

SERVER ``engine`` is ``"continuous"`` (the continuous-batching engine),
``"simple"`` (one ``Pipeline.__call__`` per POST, behind a lock) or
``"batch_image"`` (the micro-batch engine of ``serving/multimodal.py``
over PIPELINE ``task`` ``"image_generation"``: ``POST
/api/image_generation`` answers ``{"result": {"image_b64", "shape",
"dtype"}, "request_id", "engine_type"}``). The server answers, as the
reference's does:

- ``POST /api/<task>`` with ``{"input_text", "max_new_tokens",
  "request_id", "traceparent", "resume_tokens", "resume_source"}``;
- ``POST /api/<task>/stream``: Server-Sent Events, one ``token`` event
  per committed token (``id:`` = its index), then one ``done`` event; a
  body ``last_event_id`` or a ``Last-Event-ID`` header with the
  ``request_id`` reconnects and replays from the next index;
- ``GET /healthz``: 503 ``{"ready": false, "reason": "warmup"}`` while
  the engine warms, 503 ``reason: "draining"`` once a drain began, 503
  ``reason: "engine_stopped"`` after a kernel failure or a failed warmup
  (the port serves no replica whose kernels did not build), else 200;
- ``GET /stats``, ``GET /metrics`` (Prometheus text),
  ``GET /partial/<id>`` (the commit journal), ``GET /debug/requests``,
  ``GET /debug/requests/<id>`` and ``POST /debug/dump`` (a
  flight-recorder bundle into SERVER ``dump_dir``).

Backpressure maps to HTTP: queue full -> 429, prompt too long -> 413,
bad request fields -> 422, a live duplicate ``request_id`` -> 409,
draining, timeout or a stopped engine -> 503. SIGTERM drains: admission
stops, in-flight requests finish (at most ``drain_timeout_s``), a bundle
is dumped and the process exits 0. SERVER ``port`` may be 0 (any free
port; the bound one is printed).

Not yet ported (raising ``NotImplementedError``): SERVER ``phase`` other
than "both", ``peers`` (live evacuation), the AOT section, the
``embedding`` engine (its pipeline is not ported), and the fastapi app.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import Optional


@dataclasses.dataclass
class ServerConfig:
    """Every field of the reference's ``ServerConfig`` (``:75``) loads.
    ``log_level`` is kept for the reference's configs: the reference
    hands it to uvicorn, and its stdlib server, like this one, has no
    log for it to level. Features not yet ported (fleet phases,
    evacuation peers, the AOT cache, the ``embedding`` engine) raise
    ``NotImplementedError``."""

    host: str = "0.0.0.0"
    port: int = 8000
    log_level: str = "info"
    engine: str = "simple"
    warmup: bool = True
    request_timeout_s: float = 120.0
    phase: str = "both"
    drain_timeout_s: float = 30.0
    peers: tuple = ()
    dump_dir: str = "fstpu_dumps"
    #: None = cuda (raises without a card); "cpu" runs on the CPU
    device: Optional[str] = None
    engine_args: dict = dataclasses.field(default_factory=dict)
    aot_args: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.engine == "embedding":
            raise NotImplementedError(
                f"engine {self.engine!r} is not yet ported; the port "
                "serves through engine 'continuous', 'simple' or "
                "'batch_image'")
        if self.engine not in ("simple", "continuous", "batch_image"):
            raise ValueError(f"unknown engine {self.engine!r}; expected "
                             "'simple', 'continuous', 'batch_image' or "
                             "'embedding'")
        self.peers = tuple(str(p).rstrip("/")
                           for p in (self.peers or ()) if str(p).strip())
        for name, default in (("phase", "both"), ("peers", ()),
                              ("aot_args", {})):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"SERVER {name}={getattr(self, name)!r} (default "
                    f"{default!r}) is not yet ported")


@dataclasses.dataclass
class PipelineConfig:
    task: str = "text_generation"
    model: Optional[str] = None
    pipeline_args: dict = dataclasses.field(default_factory=dict)


def load_config(path: str) -> tuple[ServerConfig, PipelineConfig]:
    with open(path) as f:
        raw = json.load(f)
    server = ServerConfig(**raw.get("SERVER", {}))
    server.engine_args = dict(raw.get("ENGINE", {}))
    if raw.get("AOT"):
        raise NotImplementedError("the AOT compile cache (config section "
                                  "AOT) is not yet ported")
    pipe = raw.get("PIPELINE", {})
    pipeline = PipelineConfig(
        task=pipe.get("task", "text_generation"), model=pipe.get("model"),
        pipeline_args={k: v for k, v in pipe.items()
                       if k not in ("task", "model")})
    return server, pipeline


# -- health, metrics and debug payloads ---------------------------------------

def _healthz_payload(task: str, ready, draining,
                     stopped: Optional[str] = None) -> tuple[int, dict]:
    """The readiness contract (``fengshen_tpu/api/main.py:142``, its
    payloads byte for byte): 503 ``{"ready": false, "reason":
    "draining"|"warmup"}`` while the replica must not take traffic, 200
    ``{"ready": true}`` otherwise. The port adds ``stopped``, an
    engine's :meth:`stopped_reason`: a replica whose kernels failed to
    build or launch (in warmup or later) answers 503 ``reason:
    "engine_stopped"`` with the error, and never becomes ready."""
    if stopped is not None:
        return 503, {"status": "stopped", "task": task, "ready": False,
                     "reason": "engine_stopped", "error": stopped}
    if draining is not None and draining.is_set():
        return 503, {"status": "draining", "task": task,
                     "ready": False, "reason": "draining"}
    if ready is not None and not ready.is_set():
        return 503, {"status": "warming", "task": task,
                     "ready": False, "reason": "warmup"}
    return 200, {"status": "ok", "task": task, "ready": True}


def _render_metrics(engine=None) -> str:
    """Prometheus text over the process-global registry plus the
    continuous engine's own (``:157``); ``engine.stats()`` runs first so
    the pool gauges are scrape-fresh."""
    from fengshen_tpu_torch.observability import (get_registry,
                                                  render_prometheus)
    registries = [get_registry()]
    if engine is not None:
        engine.stats()
        if getattr(engine, "metrics", None) is not None:
            registries.append(engine.metrics.registry)
    return render_prometheus(*registries)


def _count_http(route: str, code: int) -> None:
    """``fstpu_http_requests_total{route,code}`` in the global registry."""
    from fengshen_tpu_torch.observability.httpmetrics import \
        http_requests_total
    http_requests_total().labels(route, code).inc()


def _observe_http(route: str, seconds: float) -> None:
    """``fstpu_http_request_seconds{route}`` beside the counter."""
    from fengshen_tpu_torch.observability.httpmetrics import \
        http_request_seconds
    http_request_seconds().labels(route).observe(seconds)


def _classify_route(path: str, api_route: str) -> str:
    """The route label (``:193``): ids never become labels."""
    if path.startswith("/debug/requests/"):
        return "/debug/requests/<id>"
    if path.startswith("/kv/"):
        return "/kv/<id>"
    if path.startswith("/partial/"):
        return "/partial/<id>"
    return path if path in (api_route, f"{api_route}/stream",
                            "/healthz", "/stats", "/metrics",
                            "/debug/requests", "/debug/dump") else "other"


def _dump_recorder(recorder, engine, reason: str = "on_demand") -> str:
    """``POST /debug/dump``: a forced metrics snapshot into the ring,
    then the bundle; returns its path."""
    from fengshen_tpu_torch.observability import get_registry
    registries = [get_registry()]
    if engine is not None:
        engine.stats()
        if getattr(engine, "metrics", None) is not None:
            registries.append(engine.metrics.registry)
    recorder.snapshot_metrics(registries, force=True)
    return recorder.dump(reason=reason)


def _partial_payload(engine, pipeline, request_id: str) \
        -> tuple[int, dict]:
    """``GET /partial/<id>`` (``:221``): 404 when this replica never
    journaled the id (or runs the simple engine); a finished entry also
    carries its decoded ``result``."""
    d = engine.partial(request_id) \
        if engine is not None and hasattr(engine, "partial") else None
    if d is None:
        return 404, {"error": f"unknown request_id {request_id!r}"}
    if d.get("state") == "finished" and pipeline is not None:
        d = dict(d, result=pipeline.decode(d["tokens"]))
    return 200, d


def _debug_requests_payload(engine) -> dict:
    if engine is None or not hasattr(engine, "debug_requests"):
        return {"in_flight": [], "recent": [], "debug_ring": 0}
    return engine.debug_requests()


# -- engines ------------------------------------------------------------------

def create_continuous_engine(pipeline, engine_args: dict, log=None,
                             recorder=None):
    """Build (but do not warm or start) the engine on the pipeline's
    module and device; ``recorder`` receives its events and dumps."""
    from fengshen_tpu_torch.serving import (ContinuousBatchingEngine,
                                            EngineConfig)
    kwargs = {**pipeline.engine_config_kwargs(), **engine_args}
    return ContinuousBatchingEngine(pipeline.module, EngineConfig(**kwargs),
                                    device=pipeline.device, log=log,
                                    recorder=recorder)


def start_continuous_engine(pipeline, engine_args: dict, log=None,
                            recorder=None):
    """Build, warm up and start the engine. A warmup failure (a kernel
    that does not build, say) raises: the server never starts on it."""
    engine = create_continuous_engine(pipeline, engine_args, log=log,
                                      recorder=recorder)
    dt = engine.warmup()
    print(f"[serving] continuous engine warmup "
          f"(buckets={list(engine.ladder.buckets)}, "
          f"num_slots={engine.config.num_slots}, "
          f"kv_layout={engine.config.kv_layout}, "
          f"kv_dtype={engine.config.kv_dtype}, device={engine.device}) "
          f"in {dt:.1f}s", flush=True)
    engine.start()
    return engine


class SimpleEngine:
    """The ``simple`` engine: the reference's legacy path, one
    ``Pipeline.__call__`` (a batch-1 ``utils.generate.generate``, whose
    decode steps run K3 on the card) per POST, one at a time behind a
    lock. It has no journal, streams or timelines, as the reference's
    path has none; like the continuous engine it stops for good when its
    warmup fails."""

    engine_type = "simple"

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self._lock = threading.Lock()
        self._busy = 0
        self._fatal: Optional[BaseException] = None
        self._fatal_what = ""

    def warmup(self) -> float:
        """One request of token id 1 through the pipeline (a prefill and
        one decode step); returns seconds."""
        import numpy as np

        from fengshen_tpu_torch.observability import record_warmup_seconds
        t0 = time.perf_counter()
        with self._lock:
            self.pipeline.generate_ids(np.ones((1,), np.int32), 2)
        dt = time.perf_counter() - t0
        record_warmup_seconds("pipeline", dt)
        return dt

    def generate(self, text: str, max_new_tokens: Optional[int] = None):
        from fengshen_tpu_torch.serving import EngineStopped
        if self._fatal is not None:
            raise EngineStopped(self.stopped_reason())
        with self._lock:
            self._busy += 1
            try:
                return self.pipeline(text, max_new_tokens=max_new_tokens)
            finally:
                self._busy -= 1

    def fail(self, error: BaseException, what: str) -> None:
        self._fatal, self._fatal_what = error, what

    def stopped_reason(self) -> Optional[str]:
        if self._fatal is None:
            return None
        return (f"engine stopped after {self._fatal_what}: "
                f"{type(self._fatal).__name__}: {self._fatal}")

    def begin_drain(self) -> None:
        """Nothing queues here: the server's draining event refuses new
        requests, and the one in flight finishes."""

    def idle(self) -> bool:
        return self._busy == 0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


# -- request handling ---------------------------------------------------------

def _engine_generate(engine, pipeline, req: dict,
                     timeout_s: float) -> tuple[int, dict]:
    """Submit one HTTP request to the continuous engine; returns
    ``(status, body)`` (``:334``). A ``traceparent`` (body field, or
    the header lifted into the body) puts its trace id on the request's
    timeline, and a traced response echoes ``trace_id``."""
    from fengshen_tpu_torch.observability import parse_traceparent
    from fengshen_tpu_torch.serving import (FINISHED, Draining,
                                            DuplicateRequest, EngineStopped,
                                            PromptTooLong, QueueFull)
    rid = req.get("request_id")
    ctx = parse_traceparent(req.get("traceparent"))

    def _body(payload: dict) -> dict:
        if ctx is not None:
            payload["trace_id"] = ctx.trace_id
        return payload

    try:
        request = engine.submit(
            pipeline.encode(req["input_text"]),
            max_new_tokens=req.get("max_new_tokens"),
            request_id=None if rid is None else str(rid),
            trace_id=None if ctx is None else ctx.trace_id,
            parent_span_id=None if ctx is None else ctx.span_id,
            resume_tokens=req.get("resume_tokens"),
            resume_source=req.get("resume_source"))
    except EngineStopped as e:
        return 503, _body({"error": str(e), "reason": "engine_stopped"})
    except Draining as e:
        return 503, _body({"error": str(e), "reason": "draining"})
    except DuplicateRequest as e:
        return 409, _body({"error": str(e)})
    except QueueFull as e:
        return 429, _body({"error": str(e)})
    except PromptTooLong as e:
        return 413, _body({"error": str(e)})
    except (ValueError, TypeError) as e:
        # bad request payload (unencodable input, max_new_tokens < 1)
        return 422, _body({"error": str(e)})
    if not request.wait(timeout=timeout_s):
        engine.cancel(request.request_id)
        if request.state != FINISHED:
            return 503, _body({"error":
                               f"request timed out after {timeout_s}s"})
    if request.state != FINISHED:
        body = {"error": f"request {request.state} "
                         f"({request.finish_reason})"}
        if request.finish_reason == "draining":
            body["reason"] = "draining"
        elif engine.stopped_reason() is not None:
            body.update(error=engine.stopped_reason(),
                        reason="engine_stopped")
        return 503, _body(body)
    return 200, _body({"result": pipeline.decode(request.tokens),
                       "request_id": request.request_id,
                       "generated_tokens": len(request.tokens),
                       "ttft_s": request.ttft_s,
                       "finish_reason": request.finish_reason})


def _engine_stream(engine, pipeline, req: dict, timeout_s: float):
    """``POST /api/<task>/stream`` (``:413``): submit (or reattach to) a
    request and return its SSE frames. Returns ``(code, payload, None)``
    for refusals (the blocking route's map, as plain JSON before any
    stream byte) or ``(200, None, frames)``: one ``token`` event per
    committed token (event id = token index), then one terminal
    ``done`` / ``timeout`` event. A body with ``request_id`` and
    ``last_event_id`` reconnects: no new submission, the journaled
    request's stream replays from ``last_event_id + 1``."""
    from fengshen_tpu_torch.observability import parse_traceparent
    from fengshen_tpu_torch.serving import (Draining, DuplicateRequest,
                                            EngineStopped, PromptTooLong,
                                            QueueFull)
    from fengshen_tpu_torch.streaming import format_event
    if engine is None or not hasattr(engine, "attach_stream"):
        return 501, {"error": "streaming requires the continuous "
                              "batching engine"}, None
    t0 = time.perf_counter()
    rid = req.get("request_id")
    if rid is not None and req.get("last_event_id") is not None:
        stream = engine.attach_stream(str(rid))
        if stream is None:
            return 404, {"error": f"unknown request_id {rid!r}"}, None
        engine.metrics.record_stream_reconnect()
        start = int(req["last_event_id"]) + 1
        request_id = str(rid)
    else:
        ctx = parse_traceparent(req.get("traceparent"))
        try:
            request = engine.submit(
                pipeline.encode(req["input_text"]),
                max_new_tokens=req.get("max_new_tokens"),
                request_id=None if rid is None else str(rid),
                trace_id=None if ctx is None else ctx.trace_id,
                parent_span_id=None if ctx is None else ctx.span_id,
                resume_tokens=req.get("resume_tokens"),
                resume_source=req.get("resume_source"),
                seed=req.get("seed"), stream=True)
        except EngineStopped as e:
            return 503, {"error": str(e), "reason": "engine_stopped"}, None
        except Draining as e:
            return 503, {"error": str(e), "reason": "draining"}, None
        except DuplicateRequest as e:
            return 409, {"error": str(e)}, None
        except QueueFull as e:
            return 429, {"error": str(e)}, None
        except PromptTooLong as e:
            return 413, {"error": str(e)}, None
        except (ValueError, TypeError) as e:
            return 422, {"error": str(e)}, None
        stream = engine.streams.get(request.request_id)
        start = 0
        request_id = request.request_id

    def frames():
        first = True
        for kind, idx, payload in stream.events(start, timeout=timeout_s):
            if first:
                # delivery-layer TTFB: received to first byte
                engine.metrics.record_stream_ttfb(time.perf_counter() - t0)
                first = False
            if kind == "token":
                yield format_event("token", {"token": payload},
                                   event_id=idx)
            elif kind == "evacuated":
                yield format_event(
                    "evacuated",
                    {"request_id": request_id, "target": payload},
                    event_id=idx)
            elif kind == "timeout":
                yield format_event(
                    "timeout",
                    {"request_id": request_id,
                     "error": f"no stream event within {timeout_s}s"},
                    event_id=idx)
            else:   # done
                data = {"request_id": request_id, "finish_reason": payload}
                if payload in ("eos", "length"):
                    data["result"] = pipeline.decode(stream.tokens())
                yield format_event("done", data, event_id=idx)

    return 200, None, frames()


def _simple_generate(engine: SimpleEngine, req: dict) -> tuple[int, dict]:
    """One POST through the simple engine: ``{"result": text}``."""
    from fengshen_tpu_torch.serving import EngineStopped
    try:
        return 200, {"result": engine.generate(
            req["input_text"], max_new_tokens=req.get("max_new_tokens"))}
    except EngineStopped as e:
        return 503, {"error": str(e), "reason": "engine_stopped"}
    except (ValueError, TypeError) as e:
        return 422, {"error": str(e)}


def _multimodal_generate(engine, req: dict,
                         timeout_s: float) -> tuple[int, dict]:
    """One HTTP request through a micro-batch engine (``:509``): queue
    full -> 429, draining -> 503 with its reason, a live duplicate
    ``request_id`` -> 409, a bad input -> 422, a timeout, a failed batch
    or a stopped engine -> 503. The 200 body carries the pipeline's
    result and the ``engine_type`` a router places on."""
    from fengshen_tpu_torch.serving import (Draining, DuplicateRequest,
                                            EngineStopped, QueueFull)
    from fengshen_tpu_torch.serving.multimodal import MM_FINISHED
    rid = req.get("request_id")
    try:
        request = engine.submit(req["input_text"],
                                request_id=None if rid is None
                                else str(rid))
    except EngineStopped as e:
        return 503, {"error": str(e), "reason": "engine_stopped"}
    except Draining as e:
        return 503, {"error": str(e), "reason": "draining"}
    except DuplicateRequest as e:
        return 409, {"error": str(e)}
    except QueueFull as e:
        return 429, {"error": str(e)}
    except (ValueError, TypeError) as e:
        return 422, {"error": str(e)}
    if not request.wait(timeout=timeout_s):
        engine.cancel(request.request_id)
        # the batch may have landed between the wait and the cancel: a
        # finished result is not discarded as a timeout
        if request.state != MM_FINISHED:
            return 503, {"error": f"request timed out after {timeout_s}s"}
    if request.state != MM_FINISHED:
        return 503, {"error": f"request {request.state} ({request.error})"}
    return 200, {"result": request.result,
                 "request_id": request.request_id,
                 "engine_type": engine.engine_type}


def _is_multimodal(engine) -> bool:
    from fengshen_tpu_torch.serving.multimodal import BatchImageEngine
    return isinstance(engine, BatchImageEngine)


def build_stdlib_server(server_cfg: ServerConfig,
                        pipeline_cfg: PipelineConfig, pipeline=None,
                        engine=None, ready=None, recorder=None,
                        draining=None):
    """The stdlib ``http.server`` with the routes of the module
    docstring, bound to ``server_cfg.port`` (which may be 0). ``ready``
    (a ``threading.Event``; None = ready) gates ``/healthz`` while the
    engine warms, ``draining`` (an Event) flips it to draining and
    refuses new generate requests; ``recorder`` enables ``POST
    /debug/dump``. The server counts its in-flight generate requests
    (``server.in_flight()``) so a drain can wait them out."""
    import http.server

    if pipeline is None:
        pipeline = _resolve_pipeline(pipeline_cfg, server_cfg.device)
    route = f"/api/{pipeline_cfg.task}"
    inflight_lock = threading.Lock()
    inflight = [0]
    simple = isinstance(engine, SimpleEngine)
    multimodal = _is_multimodal(engine)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_bytes(self, code: int, body: bytes,
                        content_type: str) -> None:
            label = _classify_route(self.path, route)
            _count_http(label, code)
            t0 = getattr(self, "_t_start", None)
            if t0 is not None:
                _observe_http(label, time.perf_counter() - t0)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send(self, code: int, payload: dict) -> None:
            self._send_bytes(
                code, json.dumps(payload, ensure_ascii=False).encode(),
                "application/json")

        def _send_stream(self, frames) -> None:
            """SSE response: no Content-Length; each frame is written
            and flushed as it comes, then the connection closes (the
            stream's terminator for HTTP/1.0 clients)."""
            label = _classify_route(self.path, route)
            _count_http(label, 200)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for chunk in frames:
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # the client left mid-stream; its tokens stay in the
                # journal and the stream buffer for a reconnect
                pass
            t0 = getattr(self, "_t_start", None)
            if t0 is not None:
                _observe_http(label, time.perf_counter() - t0)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._send(422, {"error": f"invalid json: {e}"})
                return None
            tp = self.headers.get("traceparent")
            if tp and not req.get("traceparent"):
                # the header form of the trace context (body field wins)
                req["traceparent"] = tp
            return req

        def do_GET(self):
            self._t_start = time.perf_counter()
            stopped = None if engine is None else engine.stopped_reason()
            if self.path == "/healthz":
                self._send(*_healthz_payload(pipeline_cfg.task, ready,
                                             draining, stopped))
            elif self.path == "/stats":
                if engine is not None and not simple:
                    self._send(200, dict(engine.stats(),
                                         phase=server_cfg.phase))
                else:
                    self._send(200, {"engine": "simple",
                                     "task": pipeline_cfg.task,
                                     "phase": server_cfg.phase})
            elif self.path == "/metrics":
                from fengshen_tpu_torch.observability import \
                    CONTENT_TYPE_LATEST
                self._send_bytes(
                    200, _render_metrics(
                        None if simple else engine).encode(),
                    CONTENT_TYPE_LATEST)
            elif self.path.startswith("/partial/"):
                rid = self.path[len("/partial/"):]
                self._send(*_partial_payload(engine, pipeline, rid))
            elif self.path == "/debug/requests":
                self._send(200, _debug_requests_payload(engine))
            elif self.path.startswith("/debug/requests/"):
                rid = self.path[len("/debug/requests/"):]
                d = engine.debug_request(rid) \
                    if hasattr(engine, "debug_request") else None
                if d is None:
                    self._send(404, {"error":
                                     f"unknown request_id {rid!r}"})
                else:
                    self._send(200, d)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            self._t_start = time.perf_counter()
            if self.path == "/debug/dump":
                if recorder is None:
                    self._send(404, {"error":
                                     "no flight recorder configured"})
                    return
                try:
                    bundle = _dump_recorder(recorder, engine)
                except Exception as e:  # noqa: BLE001 - answer, not drop
                    self._send(500, {"error": str(e)[:500]})
                    return
                self._send(200, {"bundle": bundle})
                return
            if self.path == f"{route}/stream":
                self._post_stream()
                return
            if self.path != route:
                self._send(404, {"error": "not found"})
                return
            req = self._read_json()
            if req is None:
                return
            if "input_text" not in req:
                self._send(422, {"error": "input_text required"})
                return
            if draining is not None and draining.is_set():
                # the admission edge of the drain: requests already past
                # it (counted in flight below) finish normally
                self._send(503, {"error": "replica draining",
                                 "reason": "draining"})
                return
            if engine is None:
                self._send(503, {"error": "no engine"})
                return
            with inflight_lock:
                inflight[0] += 1
            try:
                if simple:
                    code, body = _simple_generate(engine, req)
                elif multimodal:
                    code, body = _multimodal_generate(
                        engine, req, server_cfg.request_timeout_s)
                else:
                    code, body = _engine_generate(
                        engine, pipeline, req, server_cfg.request_timeout_s)
                self._send(code, body)
            except Exception as e:  # noqa: BLE001 - answer, don't die
                self._send(500, {"error": str(e)[:500]})
            finally:
                with inflight_lock:
                    inflight[0] -= 1

        def _post_stream(self):
            req = self._read_json()
            if req is None:
                return
            lei = self.headers.get("Last-Event-ID")
            if lei is not None and req.get("last_event_id") is None:
                # the SSE reconnect header, in the body form (body wins)
                try:
                    req["last_event_id"] = int(lei)
                except ValueError:
                    pass
            reconnect = req.get("request_id") is not None and \
                req.get("last_event_id") is not None
            if not reconnect and "input_text" not in req:
                self._send(422, {"error": "input_text required"})
                return
            if draining is not None and draining.is_set() and \
                    not reconnect:
                # a reconnect passes the drain edge: a live lane's
                # reader still receives its tail
                self._send(503, {"error": "replica draining",
                                 "reason": "draining"})
                return
            with inflight_lock:
                inflight[0] += 1
            try:
                code, body, frames = _engine_stream(
                    engine, pipeline, req, server_cfg.request_timeout_s)
                if frames is None:
                    self._send(code, body)
                else:
                    self._send_stream(frames)
            except Exception as e:  # noqa: BLE001 - answer, don't die
                self._send(500, {"error": str(e)[:500]})
            finally:
                with inflight_lock:
                    inflight[0] -= 1

    server = http.server.ThreadingHTTPServer(
        (server_cfg.host, server_cfg.port), Handler)
    server.in_flight = lambda: inflight[0]
    return server


# -- drain, warmup and the entry point ----------------------------------------

def drain(server, draining, engine=None, recorder=None,
          drain_timeout_s: float = 30.0, poll_s: float = 0.05):
    """The SIGTERM drain's body (``install_drain_handler``): set
    ``draining`` (``/healthz`` answers 503 "draining", new generate
    requests 503), stop the engine's admission (``begin_drain``), then,
    on a waiter thread, wait until the engine is idle and no generate
    request is in flight (at most ``drain_timeout_s``), dump the flight
    recorder and shut the server down, so ``serve_forever`` returns.
    Returns the waiter thread, or None when a drain already began."""
    if draining.is_set():
        return None
    draining.set()
    if engine is not None:
        engine.begin_drain()

    def waiter():
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            if (engine is None or engine.idle()) and \
                    server.in_flight() == 0:
                break
            time.sleep(poll_s)
        if recorder is not None:
            try:
                recorder.dump(reason="sigterm_drain")
            except Exception:  # noqa: BLE001 - a failed dump must not
                # leave the server running
                pass
        server.shutdown()

    thread = threading.Thread(target=waiter, daemon=True,
                              name="fstpu-drain")
    thread.start()
    return thread


def install_drain_handler(server, draining, engine=None, recorder=None,
                          drain_timeout_s: float = 30.0,
                          poll_s: float = 0.05):
    """SIGTERM -> :func:`drain` (``:1108``, without evacuation peers).
    It REPLACES any earlier SIGTERM handler: the flight recorder's own
    re-delivers the default disposition after its dump, which would end
    the process before the drain; the drain dumps instead. Returns the
    previous handler (for a caller to restore), or None off the main
    thread."""
    import signal
    if threading.current_thread() is not threading.main_thread():
        return None
    previous = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        drain(server, draining, engine=engine, recorder=recorder,
              drain_timeout_s=drain_timeout_s, poll_s=poll_s)

    signal.signal(signal.SIGTERM, handler)
    return previous


def _start_warmup_thread(server_cfg: ServerConfig,
                         pipeline_cfg: PipelineConfig, pipeline, engine):
    """Warm the engine in the background while the server already
    listens (``:1175``); ``/healthz`` answers 503 "warmup" until the
    returned event is set. Unlike the reference, which serves on after
    a failed warmup, a failure here stops the engine with its reason
    (``engine.fail``): ``/healthz`` then answers 503 "engine_stopped"
    with the error and generate requests 503, and the event is never
    set. A kernel that does not build or launch never makes a ready
    replica."""
    ready = threading.Event()

    def _warm():
        try:
            if isinstance(engine, SimpleEngine):
                if server_cfg.warmup:
                    dt = engine.warmup()
                    print(f"[serving] simple engine warmup request for "
                          f"'{pipeline_cfg.task}' in {dt:.1f}s",
                          flush=True)
            else:
                dt = engine.warmup()
                shape = (f"max_batch={engine.max_batch}"
                         if _is_multimodal(engine) else
                         f"buckets={list(engine.ladder.buckets)}, "
                         f"num_slots={engine.config.num_slots}")
                print(f"[serving] {engine.engine_type} engine warmup "
                      f"({shape}) ready in {dt:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001 - stop, report, never serve
            print(f"[serving] warmup failed ({type(e).__name__}: {e}); "
                  "the engine is stopped and /healthz answers 503",
                  flush=True)
            engine.fail(e, "a failed warmup")
            return
        engine.start()
        ready.set()

    threading.Thread(target=_warm, daemon=True,
                     name="fstpu-warmup").start()
    return ready


def _resolve_pipeline(pipeline_cfg: PipelineConfig, device=None):
    """The pipeline a config names (``:804``): ``Pipeline(model=...,
    **pipeline_args)`` of ``pipelines/<task>.py``, ``model`` an HF
    checkpoint directory and every other PIPELINE key a pipeline
    argument (``seed`` the sampling seed). The tasks are
    ``text_generation`` and ``image_generation``; others raise."""
    if pipeline_cfg.task == "text_generation":
        from fengshen_tpu_torch.pipelines.text_generation import Pipeline
    elif pipeline_cfg.task == "image_generation":
        from fengshen_tpu_torch.pipelines.image_generation import Pipeline
    else:
        raise NotImplementedError(
            f"task {pipeline_cfg.task!r} is not yet ported")
    return Pipeline(args=None, model=pipeline_cfg.model, device=device,
                    **pipeline_cfg.pipeline_args)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, type=str)
    args = parser.parse_args(argv)
    server_cfg, pipeline_cfg = load_config(args.config)
    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.observability import (FlightRecorder,
                                                  record_build_info)
    device = resolve_device(server_cfg.device)
    record_build_info(device=device)
    # engine tick errors, a failed warmup, the drain and POST /debug/dump
    # write bundles into dump_dir
    recorder = FlightRecorder(dump_dir=server_cfg.dump_dir)
    recorder.install_sigterm()
    pipeline = _resolve_pipeline(pipeline_cfg, device)
    if server_cfg.engine == "continuous":
        engine = create_continuous_engine(pipeline, server_cfg.engine_args,
                                          recorder=recorder)
    elif server_cfg.engine == "batch_image":
        # no slot pool and no KV handoff (``:1251``); warmup and start
        # run on the background thread below
        from fengshen_tpu_torch.serving import create_multimodal_engine
        engine = create_multimodal_engine(server_cfg.engine, pipeline,
                                          server_cfg.engine_args)
    else:
        engine = SimpleEngine(pipeline)
    ready = _start_warmup_thread(server_cfg, pipeline_cfg, pipeline, engine)
    draining = threading.Event()
    server = build_stdlib_server(server_cfg, pipeline_cfg,
                                 pipeline=pipeline, engine=engine,
                                 ready=ready, recorder=recorder,
                                 draining=draining)
    # the drain replaces the recorder's dump-then-die SIGTERM chain (the
    # dump still happens, after the drain)
    install_drain_handler(server, draining, engine=engine,
                          recorder=recorder,
                          drain_timeout_s=server_cfg.drain_timeout_s)
    host, port = server.server_address[:2]
    print(f"[serving] {server_cfg.engine} engine on {device}; "
          f"listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
