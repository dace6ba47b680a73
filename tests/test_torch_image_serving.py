"""The port's image pipeline and ``batch_image`` serving against the JAX
package, on the CPU.

- ``pipelines/image_generation``: ``byte_encode`` and ``_pack`` bytes
  equal to the JAX functions'; the small-test pipeline's image within
  1e-5 relative L2 of the JAX pipeline's on the same weights and the
  JAX draw; the full SD-1.x VAE served where the JAX pipeline raises
  (it sizes the latent from ``channel_mults``, which ``SDVAEConfig``
  lacks).
- ``serving/multimodal``: the behaviours ``tests/test_multimodal_serving.py``
  pins for the JAX engine (micro-batching in the gather window,
  ``max_batch``, queue full / duplicate / draining, cancel, a failed
  batch failing its requests but not the worker, stop, warmup, stats),
  on a stub pipeline; ``embedding`` refused as not yet ported; a failed
  warmup stopping the engine.
- ``api/main``: ``_multimodal_generate``'s HTTP codes, the stdlib
  server's dispatch, and ``Pipeline(small_test=True, device="cpu")``
  served end to end over HTTP (``/healthz`` 503 while warming, three
  concurrent POSTs riding batches, ``/stats``, the drain), then the
  ``main`` entry point from a config file in a subprocess.

Hygiene: torch runs on one intra-op thread (restored after); servers
and engines are stopped in ``finally`` blocks.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.pipelines import image_generation as port_ig
from fengshen_tpu_torch.serving import (BatchImageEngine, Draining,
                                        DuplicateRequest, EngineStopped,
                                        QueueFull, create_multimodal_engine)
from fengshen_tpu_torch.serving.multimodal import (MM_CANCELLED, MM_FAILED,
                                                   MM_FINISHED)

REL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


# -- the pipeline ----------------------------------------------------------

def test_byte_encode_and_pack_bytes_match_jax():
    from fengshen_tpu.pipelines import image_generation as jax_ig
    for text, vocab, n in (("一只橘猫", 128, 16), ("hello", 21128, 4),
                           ("", 128, 8), ("飞流直下三千尺，油画", 97, 77)):
        got, want = port_ig.byte_encode(text, vocab, n), \
            jax_ig.byte_encode(text, vocab, n)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    img = np.random.RandomState(0).uniform(0, 1, (5, 7, 3)).astype(
        np.float32)
    img[0, 0] = (0.0, 1.0, 0.998)
    assert port_ig.Pipeline._pack(img) == jax_ig.Pipeline._pack(img)


_JAX_PIPE: dict = {}


def jax_small_pipeline():
    if not _JAX_PIPE:
        from fengshen_tpu.pipelines.image_generation import Pipeline
        _JAX_PIPE["pipe"] = Pipeline(small_test=True, seed=0)
    return _JAX_PIPE["pipe"]


def port_twin(jpipe, **kw):
    """The port's pipeline on the JAX small-test pipeline's weights."""
    import jax

    from fengshen_tpu_torch.models.bert import BertConfig
    from fengshen_tpu_torch.models.stable_diffusion import (
        TaiyiStableDiffusion, UNetConfig, VAEConfig)
    from fengshen_tpu_torch.models.stable_diffusion.convert import \
        params_from_jax
    text = BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, dtype="float32")
    module = TaiyiStableDiffusion(
        text, VAEConfig.small_test_config(),
        UNetConfig.small_test_config(cross_attention_dim=32),
        device="cpu", init=False)
    module.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jpipe.params)))
    return port_ig.Pipeline(module=module, **kw)


def test_pipeline_image_matches_jax():
    """The same prompts through both pipelines, the port fed the JAX
    pipeline's draw for its first call (``fold_in(PRNGKey(seed), 1)``)."""
    import jax

    jpipe = jax_small_pipeline()
    pipe = port_twin(jpipe)
    texts = ["一只橘猫", "山水画"]
    ids = np.stack([jpipe.encode(t) for t in texts])
    np.testing.assert_array_equal(np.stack([pipe.encode(t) for t in texts]),
                                  ids)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    want = np.asarray(jpipe._generate_jit(jpipe.params, ids, rng))
    draw = jax.random.normal(rng, (2, 16, 16, 4))
    got = pipe.generate(torch.tensor(ids), nchw(draw)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert rel_l2(got, want) < REL
    pipe.draw_latents = lambda batch: nchw(draw)
    packed = pipe.run_batch(texts)
    for p, img in zip(packed, want):
        u8 = np.frombuffer(base64.b64decode(p["image_b64"]),
                           np.uint8).reshape(p["shape"])
        assert p["shape"] == [32, 32, 3] and p["dtype"] == "uint8"
        ref = (img * 255.0 + 0.5).astype(np.uint8)
        # a value within 1e-5 of a rounding edge may land one step over
        assert np.abs(u8.astype(int) - ref.astype(int)).max() <= 1


def test_full_size_vae_serves_where_jax_pipeline_raises():
    """The JAX pipeline sizes its latent from ``channel_mults``, which
    ``SDVAEConfig`` has not: it raises on the SD-1.x VAE. The port sizes
    it with ``latent_shape`` and serves."""
    import jax

    from fengshen_tpu.models.bert import BertConfig as JaxBert
    from fengshen_tpu.models.stable_diffusion import (SDUNetConfig,
                                                      SDVAEConfig,
                                                      TaiyiStableDiffusion)
    from fengshen_tpu.models.stable_diffusion.sampling import \
        init_sampling_params
    from fengshen_tpu.pipelines.image_generation import Pipeline as JaxPipe
    from fengshen_tpu_torch.models import stable_diffusion as psd
    from fengshen_tpu_torch.models.bert import BertConfig
    text = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64, dtype="float32")
    jm = TaiyiStableDiffusion(JaxBert(**text),
                              SDVAEConfig.small_test_config(),
                              SDUNetConfig.small_test_config())
    params = init_sampling_params(jm, jax.random.PRNGKey(0), 16)
    jpipe = JaxPipe(module=jm, params=params, image_size=16,
                    num_inference_steps=2)
    with pytest.raises(AttributeError, match="channel_mults"):
        jpipe.run_batch(["一只猫"])
    pm = psd.TaiyiStableDiffusion(
        BertConfig(**text), psd.SDVAEConfig.small_test_config(),
        psd.SDUNetConfig.small_test_config(), device="cpu")
    pipe = port_ig.Pipeline(module=pm, image_size=16,
                            num_inference_steps=2)
    out = pipe.run_batch(["一只猫", "两只猫"])
    assert [o["shape"] for o in out] == [[16, 16, 3]] * 2


def test_pipeline_surface():
    from fengshen_tpu_torch.observability import get_registry
    with pytest.raises(ValueError, match="small_test"):
        port_ig.Pipeline(device="cpu")
    with pytest.raises(ValueError, match="convert"):
        port_ig.Pipeline(model="some/dir", device="cpu")
    pipe = port_ig.Pipeline(small_test=True, device="cpu", seed=3)
    assert pipe.task == "image_generation" and pipe.warmup_input()
    counter = get_registry().counter("fstpu_pipeline_images_total")
    before = counter.value()
    a, b = pipe("一只猫"), pipe("一只猫")
    assert counter.value() == before + 2
    # the draw moves with the call count and repeats from the seed
    assert a["image_b64"] != b["image_b64"]
    again = port_ig.Pipeline(module=pipe.module, seed=3)
    assert again("一只猫") == a

    class Tok:
        def encode(self, text):
            return [5] * 40

    assert list(port_ig.Pipeline(module=pipe.module, tokenizer=Tok())
                .encode("x")) == [5] * 16


# -- the engine on a stub pipeline ------------------------------------------

class FakePipeline:
    """Records the batches the engine launches."""

    def __init__(self, fail=False, delay_s=0.0):
        self.batches = []
        self.fail = fail
        self.delay_s = delay_s

    def warmup_input(self):
        return "warmup"

    def run_batch(self, inputs):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batches.append(list(inputs))
        if self.fail:
            raise RuntimeError("tower exploded")
        return [{"result_for": text} for text in inputs]


def _engine(pipeline=None, **kw):
    kw.setdefault("gather_ms", 20.0)
    return BatchImageEngine(pipeline if pipeline is not None
                            else FakePipeline(), **kw)


def test_engine_requires_run_batch_pipeline():
    class TextPipeline:
        def __call__(self, text):
            return text

    with pytest.raises(ValueError, match="run_batch"):
        BatchImageEngine(TextPipeline())


def test_create_multimodal_engine_table():
    eng = create_multimodal_engine("batch_image", FakePipeline(),
                                   {"max_batch": 3, "gather_ms": 0.0})
    assert isinstance(eng, BatchImageEngine)
    assert eng.engine_type == "batch_image"
    assert eng.max_batch == 3 and eng.gather_ms == 0.0
    with pytest.raises(NotImplementedError, match="not yet ported"):
        create_multimodal_engine("embedding", FakePipeline())
    with pytest.raises(ValueError, match="unknown multimodal engine"):
        create_multimodal_engine("continuous", FakePipeline())


def test_submit_wait_finish_roundtrip():
    eng = _engine()
    eng.start()
    try:
        req = eng.submit("你好")
        assert req.wait(timeout=10)
        assert req.state == MM_FINISHED
        assert req.result == {"result_for": "你好"}
        assert req.request_id.startswith("batch_image-")
    finally:
        eng.stop()
    assert eng.idle()


def test_requests_in_gather_window_ride_one_batch():
    pipe = FakePipeline()
    eng = _engine(pipe, max_batch=4, gather_ms=200.0)
    reqs = [eng.submit(f"p{i}") for i in range(3)]
    eng.start()
    try:
        for r in reqs:
            assert r.wait(timeout=10) and r.state == MM_FINISHED
    finally:
        eng.stop()
    assert pipe.batches == [["p0", "p1", "p2"]]
    stats = eng.stats()
    assert stats["batches_total"] == 1 and stats["avg_batch"] == 3.0


def test_batch_never_exceeds_max_batch():
    pipe = FakePipeline()
    eng = _engine(pipe, max_batch=2, gather_ms=50.0)
    reqs = [eng.submit(f"p{i}") for i in range(5)]
    eng.start()
    try:
        for r in reqs:
            assert r.wait(timeout=10) and r.state == MM_FINISHED
    finally:
        eng.stop()
    assert all(len(b) <= 2 for b in pipe.batches)
    assert sum(len(b) for b in pipe.batches) == 5


def test_admission_contract_queue_full_duplicate_drain():
    eng = _engine(max_queue=2)  # no worker: nothing drains
    eng.submit("a", request_id="r1")
    with pytest.raises(DuplicateRequest):
        eng.submit("a again", request_id="r1")
    eng.submit("b")
    with pytest.raises(QueueFull):
        eng.submit("c")
    with pytest.raises(ValueError, match="empty input"):
        eng.submit("   ")
    eng.begin_drain()
    with pytest.raises(Draining):
        eng.submit("d", request_id="r9")
    assert eng.stats()["draining"] is True


def test_cancel_queued_request():
    eng = _engine()
    req = eng.submit("a", request_id="doomed")
    assert eng.cancel("doomed") is True
    assert req.state == MM_CANCELLED
    assert eng.cancel("doomed") is False
    assert eng.cancel("never-existed") is False
    eng.submit("retry", request_id="doomed")  # the id is free again


def test_batch_failure_answers_requests_not_worker():
    pipe = FakePipeline(fail=True)
    eng = _engine(pipe)
    eng.start()
    try:
        req = eng.submit("a")
        assert req.wait(timeout=10)
        assert req.state == MM_FAILED and "tower exploded" in req.error
        pipe.fail = False
        ok = eng.submit("b")
        assert ok.wait(timeout=10) and ok.state == MM_FINISHED
    finally:
        eng.stop()


def test_stop_cancels_queued_requests():
    eng = _engine()
    req = eng.submit("never served")
    eng.stop()
    assert req.state == MM_CANCELLED and req.error == "engine stopped"


def test_warmup_runs_max_batch_and_stats_record_it():
    pipe = FakePipeline()
    eng = _engine(pipe, max_batch=3)
    dt = eng.warmup()
    assert dt >= 0 and pipe.batches == [["warmup"] * 3]
    stats = eng.stats()
    assert stats["engine_type"] == "batch_image"
    assert stats["warmup_s"] == dt and stats["max_batch"] == 3
    assert stats["queue_depth"] == 0 and stats["in_flight"] == 0


def test_failed_engine_refuses_with_its_reason():
    eng = _engine()
    queued = eng.submit("a")
    assert eng.stopped_reason() is None
    eng.fail(RuntimeError("no kernel"), "a failed warmup")
    assert queued.state == MM_CANCELLED
    assert "a failed warmup" in eng.stopped_reason()
    with pytest.raises(EngineStopped, match="no kernel"):
        eng.submit("b")


# -- the HTTP mapping -------------------------------------------------------

def _mm_generate(engine, req, timeout_s=10.0):
    from fengshen_tpu_torch.api.main import _multimodal_generate
    return _multimodal_generate(engine, req, timeout_s)


def test_multimodal_generate_success_carries_engine_type():
    eng = _engine()
    eng.start()
    try:
        code, body = _mm_generate(eng, {"input_text": "一只猫"})
        assert code == 200 and body["result"] == {"result_for": "一只猫"}
        assert body["engine_type"] == "batch_image" and body["request_id"]
    finally:
        eng.stop()


def test_multimodal_generate_refusal_codes():
    eng = _engine(max_queue=1)  # no worker: deterministic backpressure
    eng.submit("filler", request_id="dup")
    assert _mm_generate(eng, {"input_text": "x",
                              "request_id": "dup"})[0] == 409
    assert _mm_generate(eng, {"input_text": "x"})[0] == 429
    assert _mm_generate(eng, {"input_text": "  "})[0] == 422
    eng.begin_drain()
    code, body = _mm_generate(eng, {"input_text": "x"})
    assert code == 503 and body["reason"] == "draining"
    stopped = _engine()
    stopped.fail(RuntimeError("boom"), "a failed warmup")
    code, body = _mm_generate(stopped, {"input_text": "x"})
    assert code == 503 and body["reason"] == "engine_stopped"


def test_multimodal_generate_timeout_and_failed_batch_503():
    eng = _engine()  # no worker: the wait cannot be met
    code, body = _mm_generate(eng, {"input_text": "x"}, timeout_s=0.05)
    assert code == 503 and "timed out" in body["error"]
    assert eng.idle()  # the timed-out request left the queue
    bad = _engine(FakePipeline(fail=True))
    bad.start()
    try:
        code, body = _mm_generate(bad, {"input_text": "x"})
        assert code == 503
        assert "failed" in body["error"] and "tower exploded" in \
            body["error"]
    finally:
        bad.stop()


def test_server_config_engine_names():
    from fengshen_tpu_torch.api.main import ServerConfig
    for name in ("simple", "continuous", "batch_image"):
        assert ServerConfig(engine=name).engine == name
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ServerConfig(engine="embedding")
    with pytest.raises(ValueError, match="batch_image"):
        ServerConfig(engine="micro")


# -- the server -------------------------------------------------------------

def _serve(engine, pipeline, ready=None, draining=None):
    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             build_stdlib_server)
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, engine="batch_image",
                     device="cpu"),
        PipelineConfig(task="image_generation"), pipeline=pipeline,
        engine=engine, ready=ready, draining=draining)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _http(port, path, payload=None, timeout=120):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_stdlib_server_dispatches_batch_image_engine():
    pipe = FakePipeline()
    eng = _engine(pipe)
    eng.start()
    server, port = _serve(eng, pipe)
    try:
        code, out = _http(port, "/api/image_generation",
                          {"input_text": "测试", "request_id": "q1"})
        assert code == 200 and out["engine_type"] == "batch_image"
        assert out["result"] == {"result_for": "测试"}
        assert out["request_id"] == "q1"
        code, stats = _http(port, "/stats")
        assert stats["engine_type"] == "batch_image"
        assert stats["requests_total"] == 1 and stats["phase"] == "both"
        assert _http(port, "/api/image_generation",
                     {"input_text": "  "})[0] == 422
        assert _http(port, "/api/image_generation", {})[0] == 422
        assert _http(port, "/api/image_generation/stream",
                     {"input_text": "x"})[0] == 501
        assert _http(port, "/partial/q1")[0] == 404
        assert _http(port, "/healthz") == (200, {
            "status": "ok", "task": "image_generation", "ready": True})
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def test_small_test_pipeline_served_over_http():
    """``Pipeline(small_test=True, device="cpu")`` behind the engine and
    the stdlib server: 503 while warming, three concurrent POSTs (a
    batch of 2 among them), ``/stats``, ``/metrics``, then the drain."""
    from fengshen_tpu_torch.api.main import _start_warmup_thread
    from fengshen_tpu_torch.api.main import PipelineConfig, ServerConfig
    pipe = port_ig.Pipeline(small_test=True, device="cpu", seed=0)
    eng = BatchImageEngine(pipe, max_batch=2, gather_ms=200.0)
    gate = threading.Event()
    warm = eng.warmup

    def slow_warmup():
        gate.wait(30)
        return warm()

    eng.warmup = slow_warmup
    ready = _start_warmup_thread(ServerConfig(engine="batch_image"),
                                 PipelineConfig(task="image_generation"),
                                 pipe, eng)
    draining = threading.Event()
    server, port = _serve(eng, pipe, ready=ready, draining=draining)
    try:
        code, body = _http(port, "/healthz")
        assert code == 503 and body["reason"] == "warmup"
        gate.set()
        assert ready.wait(120)
        assert _http(port, "/healthz")[0] == 200
        results = [None] * 3

        def post(i):
            results[i] = _http(port, "/api/image_generation",
                               {"input_text": f"第{i}只猫"})

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for code, out in results:
            assert code == 200 and out["engine_type"] == "batch_image"
            img = np.frombuffer(base64.b64decode(out["result"]["image_b64"]),
                                np.uint8)
            assert out["result"]["shape"] == [32, 32, 3]
            assert img.size == 32 * 32 * 3
        code, stats = _http(port, "/stats")
        # the warmup batch, then the three requests in batches of <= 2
        assert stats["requests_total"] == 3
        assert stats["batches_total"] == 2 and stats["avg_batch"] == 1.5
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "fstpu_pipeline_images_total" in text
        assert 'span="pipeline/image_batch"' in text
        # the drain's admission edge (an idle replica's drain then shuts
        # the server down at once)
        draining.set()
        eng.begin_drain()
        code, body = _http(port, "/api/image_generation",
                           {"input_text": "late"})
        assert code == 503 and body["reason"] == "draining"
        assert _http(port, "/healthz")[1]["reason"] == "draining"
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def test_api_main_serves_batch_image_from_a_config(tmp_path):
    """``python -m fengshen_tpu_torch.api.main --config`` with the
    ``batch_image`` engine over the small-test pipeline on the CPU: the
    printed port answers a POST, and SIGTERM drains it to exit 0."""
    import signal
    cfg = tmp_path / "server.json"
    cfg.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "device": "cpu",
                   "engine": "batch_image",
                   "dump_dir": str(tmp_path / "dumps")},
        "ENGINE": {"max_batch": 2, "gather_ms": 5.0},
        "PIPELINE": {"task": "image_generation", "small_test": True,
                     "image_size": 16, "num_inference_steps": 2}}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fengshen_tpu_torch.api.main", "--config",
         str(cfg)], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
        assert port, "the server printed no port"
        while _http(port, "/healthz")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        code, out = _http(port, "/api/image_generation",
                          {"input_text": "一只猫"})
        assert code == 200 and out["result"]["shape"] == [16, 16, 3]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
