"""REST serving through the continuous-batching engine: the
continuous-engine subset of ``fengshen_tpu/api/main.py``.

A JSON config names the server options (SERVER), engine overrides
(ENGINE, ``serving.EngineConfig`` fields) and the pipeline (PIPELINE);
the stdlib HTTP server exposes ``POST /api/text_generation`` with
``{"input_text": ..., "max_new_tokens": ...}``, ``GET /healthz`` and
``GET /stats``:

    python -m fengshen_tpu_torch.api.main --config server.json

Backpressure maps to HTTP as in the reference: queue full -> 429, prompt
too long -> 413, bad request fields -> 422, timeout or engine failure ->
503. An engine stopped by a kernel failure answers 503 with the reason,
and ``GET /healthz`` then answers 503 ``{"ready": false, "reason": ...}``.
SERVER ``port`` may be 0 (any free port; the bound one is printed).

Loading checkpoint weights is not yet ported: PIPELINE ``model`` names a
LLaMA ``config.json`` (or its directory), the weights are made on the
device from PIPELINE ``seed``, and the tokenizer is the ids-as-text
:class:`~fengshen_tpu_torch.pipelines.text_generation.IdTokenizer`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ServerConfig:
    """Every field of the reference's ``ServerConfig`` (``:75``) loads;
    those of features not yet ported (fleet phases, drain, evacuation
    peers, dump bundles, the AOT cache, log levels) raise
    ``NotImplementedError`` for anything but their defaults."""

    host: str = "0.0.0.0"
    port: int = 8000
    log_level: str = "info"
    engine: str = "continuous"
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
        if self.engine != "continuous":
            raise NotImplementedError(
                f"engine {self.engine!r} is not yet ported; the port "
                "serves through engine 'continuous'")
        self.peers = tuple(self.peers or ())
        for f in dataclasses.fields(self):
            if f.name not in ("log_level", "phase", "drain_timeout_s",
                              "peers", "dump_dir", "aot_args"):
                continue
            default = f.default_factory() if \
                f.default is dataclasses.MISSING else f.default
            if getattr(self, f.name) != default:
                raise NotImplementedError(
                    f"SERVER {f.name}={getattr(self, f.name)!r} (default "
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


def create_continuous_engine(pipeline, engine_args: dict, log=None):
    """Build (but do not warm or start) the engine on the pipeline's
    module and device."""
    from fengshen_tpu_torch.serving import (ContinuousBatchingEngine,
                                            EngineConfig)
    kwargs = {**pipeline.engine_config_kwargs(), **engine_args}
    return ContinuousBatchingEngine(pipeline.module, EngineConfig(**kwargs),
                                    device=pipeline.device, log=log)


def start_continuous_engine(pipeline, engine_args: dict, log=None):
    """Build, warm up and start the engine. A warmup failure (a kernel
    that does not build, say) raises: the server never starts on it."""
    engine = create_continuous_engine(pipeline, engine_args, log=log)
    dt = engine.warmup()
    print(f"[serving] continuous engine warmup "
          f"(buckets={list(engine.ladder.buckets)}, "
          f"num_slots={engine.config.num_slots}, "
          f"kv_layout={engine.config.kv_layout}, "
          f"kv_dtype={engine.config.kv_dtype}, device={engine.device}) "
          f"in {dt:.1f}s", flush=True)
    engine.start()
    return engine


def _engine_generate(engine, pipeline, req: dict,
                     timeout_s: float) -> tuple[int, dict]:
    """Submit one HTTP request to the engine; returns (status, body)."""
    from fengshen_tpu_torch.serving import (FINISHED, EngineStopped,
                                            PromptTooLong, QueueFull)
    rid = req.get("request_id")
    try:
        request = engine.submit(
            pipeline.encode(req["input_text"]),
            max_new_tokens=req.get("max_new_tokens"),
            request_id=None if rid is None else str(rid))
    except EngineStopped as e:
        return 503, {"error": str(e), "reason": "engine_stopped"}
    except QueueFull as e:
        return 429, {"error": str(e)}
    except PromptTooLong as e:
        return 413, {"error": str(e)}
    except (ValueError, TypeError) as e:
        # bad request payload (unencodable input, max_new_tokens < 1)
        return 422, {"error": str(e)}
    if not request.wait(timeout=timeout_s):
        engine.cancel(request.request_id)
        if request.state != FINISHED:
            return 503, {"error": f"request timed out after {timeout_s}s"}
    if request.state != FINISHED:
        return 503, {"error": f"request {request.state} "
                              f"({request.finish_reason})"}
    return 200, {"result": pipeline.decode(request.tokens),
                 "request_id": request.request_id,
                 "generated_tokens": len(request.tokens),
                 "ttft_s": request.ttft_s,
                 "finish_reason": request.finish_reason}


def _healthz_payload(task: str, engine=None) -> tuple[int, dict]:
    """The reference's readiness contract (``fengshen_tpu/api/main.py:142``):
    503 with ``{"ready": false, "reason": ...}`` while the replica must
    not take traffic (here: its engine stopped after a kernel failure),
    200 with ``{"ready": true}`` otherwise."""
    stopped = None if engine is None else engine.stopped_reason()
    if stopped is not None:
        return 503, {"status": "stopped", "task": task, "ready": False,
                     "reason": "engine_stopped", "error": stopped}
    return 200, {"status": "ok", "task": task, "ready": True}


def build_stdlib_server(server_cfg: ServerConfig,
                        pipeline_cfg: PipelineConfig, pipeline=None,
                        engine=None):
    """``http.server`` exposing ``POST /api/<task>``, ``GET /healthz``
    and ``GET /stats``. Binds ``server_cfg.port``, which may be 0. The
    engine is warmed before the server is built, so the server is ready
    as soon as it listens."""
    import http.server

    if pipeline is None:
        pipeline = _resolve_pipeline(pipeline_cfg, server_cfg.device)
    route = f"/api/{pipeline_cfg.task}"

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(*_healthz_payload(pipeline_cfg.task, engine))
            elif self.path == "/stats":
                if engine is None:
                    self._send(404, {"error": "no engine"})
                else:
                    self._send(200, engine.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != route:
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._send(422, {"error": f"invalid json: {e}"})
                return
            if "input_text" not in req:
                self._send(422, {"error": "input_text required"})
                return
            if engine is None:
                self._send(503, {"error": "no engine"})
                return
            try:
                code, body = _engine_generate(
                    engine, pipeline, req, server_cfg.request_timeout_s)
            except Exception as e:  # noqa: BLE001 - answer, don't die
                code, body = 500, {"error": str(e)[:500]}
            self._send(code, body)

    return http.server.ThreadingHTTPServer(
        (server_cfg.host, server_cfg.port), Handler)


def _resolve_pipeline(pipeline_cfg: PipelineConfig, device=None):
    """The text-generation pipeline a config names. Until checkpoint
    loading is ported, ``model`` names only the architecture (a
    ``config.json`` or its directory) and the weights are made on the
    device from ``seed``."""
    import torch

    from fengshen_tpu_torch.device import resolve_device
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    if pipeline_cfg.task != "text_generation":
        raise NotImplementedError(
            f"task {pipeline_cfg.task!r} is not yet ported")
    if pipeline_cfg.model is None:
        raise ValueError("PIPELINE.model must name a LLaMA config.json "
                         "(or its directory)")
    args = dict(pipeline_cfg.pipeline_args)
    config = LlamaConfig.from_pretrained(pipeline_cfg.model)
    for key in ("dtype", "param_dtype"):
        if key in args:
            setattr(config, key, args.pop(key))
    dev = resolve_device(device)
    seed = int(args.get("seed", 0))
    module = LlamaForCausalLM(
        config, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))
    print(f"[serving] weights of {pipeline_cfg.model} made on {dev} from "
          f"seed {seed} (checkpoint loading is not yet ported)", flush=True)
    return Pipeline(module=module, tokenizer=IdTokenizer(), device=dev,
                    **args)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, type=str)
    args = parser.parse_args(argv)
    server_cfg, pipeline_cfg = load_config(args.config)
    pipeline = _resolve_pipeline(pipeline_cfg, server_cfg.device)
    engine = create_continuous_engine(pipeline, server_cfg.engine_args)
    if server_cfg.warmup:
        dt = engine.warmup()
        print(f"[serving] warmup in {dt:.1f}s", flush=True)
    engine.start()
    server = build_stdlib_server(server_cfg, pipeline_cfg,
                                 pipeline=pipeline, engine=engine)
    host, port = server.server_address[:2]
    print(f"[serving] listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
