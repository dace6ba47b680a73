"""Greedy generation and serving in the port, on the CPU.

- The port's ``generate`` against the JAX package's ``generate`` on one
  left-padded batch with the same weights (``params_from_jax``):
  token-identical, except that a step may differ where the JAX top-2
  logit margin is below ``MARGIN_EPS`` = 1e-4 (fp32 logits of two
  implementations differ by ~1e-6, so only a near-tie may flip; after a
  flip the sequences legitimately part, so the comparison stops there).
- The port's continuous-batching engine (slot and paged pools,
  staggered admission, slot reclaim, eos) against the port's own
  ``generate``, exactly.
- ``BlockAllocator`` accounting, the engine's config gates, and one
  HTTP round trip through ``build_stdlib_server`` on ``127.0.0.1:0``.
"""

import functools
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fengshen_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from fengshen_tpu.models.llama import LlamaForCausalLM as JaxLlama
from fengshen_tpu.utils.generate import generate as jax_generate
from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                         build_stdlib_server,
                                         start_continuous_engine)
from fengshen_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                             params_from_jax)
from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                          Pipeline)
from fengshen_tpu_torch.serving import (BlockAllocator,
                                        ContinuousBatchingEngine,
                                        EngineConfig, PromptTooLong,
                                        QueueFull)
from fengshen_tpu_torch.utils.generate import generate

MARGIN_EPS = 1e-4
MAX_NEW = 10
CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64, dtype="float32",
           param_dtype="float32", initializer_range=0.2)
LENGTHS = (5, 11, 16, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 96, n).astype(np.int32) for n in lengths]


def _left_pad(prompts):
    width = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        ids[i, width - len(p):] = p
        mask[i, width - len(p):] = 1
    return ids, mask


@pytest.fixture(scope="module")
def jax_side():
    """JAX params, greedy output on the padded batch, and the JAX logits
    of that output (one teacher-forced forward) for the margins."""
    cfg = JaxLlamaConfig(**CFG)
    model = JaxLlama(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
    ids, mask = _left_pad(_prompts())
    run = jax.jit(functools.partial(jax_generate, model,
                                    max_new_tokens=MAX_NEW))
    out = np.asarray(run(params, jnp.asarray(ids),
                         attention_mask=jnp.asarray(mask)))
    full_mask = np.concatenate(
        [mask, np.ones((len(ids), MAX_NEW), np.int32)], axis=1)
    pos = np.clip(full_mask.cumsum(-1) - 1, 0, None)
    logits = jax.jit(model.apply)({"params": params}, jnp.asarray(out),
                                  attention_mask=jnp.asarray(full_mask),
                                  position_ids=jnp.asarray(pos))
    return (jax.tree_util.tree_map(np.asarray, params), out,
            np.asarray(logits))


@pytest.fixture(scope="module")
def port_model(jax_side):
    cfg = LlamaConfig(**CFG)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax_side[0], cfg))
    return model


@pytest.fixture(scope="module")
def port_refs(port_model):
    """Batch-1 unpadded port ``generate`` per prompt, the engine's bar."""
    return [generate(port_model, p[None], max_new_tokens=MAX_NEW,
                     device="cpu")[0, len(p):].tolist()
            for p in _prompts()]


def test_generate_matches_jax(jax_side, port_model):
    _, jax_out, jax_logits = jax_side
    ids, mask = _left_pad(_prompts())
    out = generate(port_model, ids, attention_mask=mask,
                   max_new_tokens=MAX_NEW, device="cpu").numpy()
    width = ids.shape[1]
    np.testing.assert_array_equal(out[:, :width], ids)
    compared = 0
    for row in range(len(ids)):
        for t in range(width, width + MAX_NEW):
            if out[row, t] == jax_out[row, t]:
                compared += 1
                continue
            top2 = np.sort(jax_logits[row, t - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN_EPS, (
                f"row {row} step {t - width}: port {out[row, t]} vs JAX "
                f"{jax_out[row, t]} at margin {top2[1] - top2[0]}")
            break
    assert compared >= len(ids) * MAX_NEW // 2


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_matches_generate_staggered(port_model, port_refs, layout):
    """Requests admitted at different ticks, across two buckets, through
    a pool smaller than the request count (slot reclaim)."""
    prompts = _prompts()
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, buckets=(8, 16),
                                 max_new_tokens=MAX_NEW, max_queue=16,
                                 kv_layout=layout, kv_block_size=8),
        device="cpu")
    reqs = [eng.submit(prompts[0]), eng.submit(prompts[1])]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p) for p in prompts[2:]]
    eng.run_until_idle()
    for req, ref in zip(reqs, port_refs):
        assert req.tokens == ref
        assert (req.state, req.finish_reason) == ("finished", "length")
    stats = eng.stats()
    assert stats["completed"] == 4 and stats["slots_active"] == 0
    assert stats["prefills_per_bucket"] == {8: 2, 16: 2}
    if layout == "paged":
        assert stats["kv_blocks_used"] == 0


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_eos_finishes_early(port_model, port_refs, layout):
    prompt = _prompts()[1]
    eos = port_refs[1][3]
    ref = generate(port_model, prompt[None], max_new_tokens=MAX_NEW,
                   eos_token_id=eos, device="cpu")[0, len(prompt):].tolist()
    ref = ref[:ref.index(eos) + 1]
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, buckets=(16,),
                                 max_new_tokens=MAX_NEW, eos_token_id=eos,
                                 kv_layout=layout, kv_block_size=8),
        device="cpu")
    (tokens,) = eng.generate_all([prompt])
    assert tokens == ref and tokens[-1] == eos


def test_paged_engine_defers_until_blocks_free(port_model, port_refs):
    """A pool too small for two requests at once serves them one after
    the other, with the same tokens."""
    prompts = _prompts()
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, buckets=(16,),
                                 max_new_tokens=MAX_NEW, kv_layout="paged",
                                 kv_block_size=8, kv_num_blocks=5),
        device="cpu")
    assert eng.generate_all(prompts[2:4]) == port_refs[2:4]
    assert eng.stats()["deferred_admissions"] == 1


def test_block_allocator_accounting():
    alloc = BlockAllocator(6)
    assert (alloc.total_blocks, alloc.free_blocks) == (5, 5)
    a = alloc.alloc(2)
    b = alloc.alloc(3)
    assert a == [1, 2] and b == [3, 4, 5]       # lowest id first, no null
    assert alloc.alloc(1) is None               # exhausted: caller defers
    alloc.free(a)
    assert (alloc.used_blocks, alloc.free_blocks) == (3, 2)
    assert alloc.alloc(1) == [2]                # LIFO reuse
    with pytest.raises(ValueError, match="double-free"):
        alloc.free(a)
    with pytest.raises(ValueError):
        alloc.alloc(0)
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_engine_backpressure_and_config_gates(port_model):
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=1, buckets=(8,), max_queue=1),
        device="cpu")
    with pytest.raises(PromptTooLong):
        eng.submit(np.arange(3, 12))
    eng.submit(np.arange(3, 6))
    with pytest.raises(QueueFull):
        eng.submit(np.arange(3, 6))
    with pytest.raises(ValueError):
        eng.submit(np.arange(3, 6), max_new_tokens=0)
    for kw in (dict(spec_mode="prompt_lookup"), dict(kv_dtype="int8"),
               dict(do_sample=True), dict(repetition_penalty=1.2),
               dict(min_length=3)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            EngineConfig(**kw)
    with pytest.raises(ValueError):
        EngineConfig(kv_layout="ring")


def test_reference_config_fields_all_load():
    """Every field of the reference's ``EngineConfig`` and
    ``ServerConfig`` is a field of the port's; the reference's defaults
    load, and a value other than the default of a feature the port lacks
    raises ``NotImplementedError`` (never ``TypeError``)."""
    import dataclasses

    from fengshen_tpu.api.main import ServerConfig as JaxServerConfig
    from fengshen_tpu.serving.engine import EngineConfig as JaxEngineConfig
    for ref_cls, port_cls in ((JaxEngineConfig, EngineConfig),
                              (JaxServerConfig, ServerConfig)):
        ref = {f.name for f in dataclasses.fields(ref_cls)}
        port = {f.name for f in dataclasses.fields(port_cls)}
        assert ref <= port, sorted(ref - port)
    EngineConfig(**dataclasses.asdict(JaxEngineConfig()))
    defaults = dataclasses.asdict(JaxServerConfig())
    defaults.pop("engine")                  # the reference's is "simple"
    ServerConfig(**defaults)
    for kw in (dict(spec_gamma=6), dict(spec_ngram=3),
               dict(spec_draft_layers=4), dict(debug_ring=8),
               dict(journal_ring=16)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            EngineConfig(**kw)
    for kw in (dict(phase="prefill"), dict(drain_timeout_s=5.0),
               dict(peers=("http://a:1",)), dict(dump_dir="/tmp/x"),
               dict(log_level="debug"), dict(aot_args={"cache_dir": "d"})):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ServerConfig(**kw)


def test_reference_config_file_loads(tmp_path):
    """A config written for ``fengshen_tpu.api.main`` naming the
    reference-only fields at their defaults loads."""
    from fengshen_tpu_torch.api.main import load_config
    path = tmp_path / "server.json"
    path.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "engine": "continuous",
                   "log_level": "info", "phase": "both",
                   "drain_timeout_s": 30.0, "dump_dir": "fstpu_dumps"},
        "ENGINE": {"num_slots": 2, "spec_mode": "off", "spec_gamma": 4,
                   "spec_ngram": 2, "debug_ring": 64, "journal_ring": 256},
        "PIPELINE": {"task": "text_generation", "model": "m"}}))
    server, pipeline = load_config(str(path))
    assert EngineConfig(**server.engine_args).spec_gamma == 4
    assert pipeline.model == "m"


def test_stopped_engine_answers_503_and_reports_unready(port_model,
                                                       monkeypatch):
    """A kernel entry that raises stops the engine: the request in flight
    and every later one answer 503 with a reason, and ``/healthz``
    answers 503 ``{"ready": false, "reason": ...}`` (the reference's
    readiness contract)."""
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.ops.kernels import KernelError
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=4, device="cpu")
    engine = start_continuous_engine(pipe, {"num_slots": 2,
                                            "buckets": (8,)})

    def broken(*args, **kwargs):
        raise KernelError("injected launch failure")

    monkeypatch.setattr(modeling_llama, "decode_attention", broken)
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, device="cpu"),
        PipelineConfig(task="text_generation"), pipeline=pipe,
        engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for _ in range(2):          # the request in flight, then a new one
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(port, {"input_text": "5 7 9"}, timeout=30)
            assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert body["reason"] == "engine_stopped"
        assert "injected launch failure" in body["error"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        assert exc.value.code == 503
        health = json.loads(exc.value.read())
        assert health["ready"] is False
        assert health["reason"] == "engine_stopped"
        assert "KernelError" in health["error"]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_stopped_engine_refuses_the_request_after_the_failure(
        port_model, monkeypatch):
    """The engine is marked stopped before the in-flight request fails,
    so a retry sent as soon as that request finishes is refused, never
    queued behind a serve thread that has exited."""
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.ops.kernels import KernelError
    from fengshen_tpu_torch.serving import EngineStopped
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=4, device="cpu")
    engine = start_continuous_engine(pipe, {"num_slots": 2,
                                            "buckets": (8,)})

    def broken(*args, **kwargs):
        raise KernelError("injected launch failure")

    monkeypatch.setattr(modeling_llama, "decode_attention", broken)
    try:
        req = engine.submit([5, 7, 9])
        assert req.wait(timeout=30)
        assert req.finish_reason == "engine_error"
        with pytest.raises(EngineStopped, match="injected launch failure"):
            engine.submit([5, 7, 9])
    finally:
        engine.stop()


def _post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/text_generation",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_stdlib_server_round_trip(jax_side, port_refs):
    """A pipeline over a fresh model given the JAX weights as
    ``params`` serves the same tokens as ``generate``."""
    cfg = LlamaConfig(**CFG)
    pipe = Pipeline(module=LlamaForCausalLM(cfg, device="cpu"),
                    params=params_from_jax(jax_side[0], cfg),
                    tokenizer=IdTokenizer(), max_new_tokens=MAX_NEW,
                    device="cpu")
    engine = start_continuous_engine(
        pipe, {"num_slots": 2, "buckets": (8, 16), "kv_layout": "paged",
               "kv_block_size": 8})
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, device="cpu"),
        PipelineConfig(task="text_generation"), pipeline=pipe,
        engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        prompt = _prompts()[0]
        out = _post(port, {"input_text": " ".join(map(str, prompt))})
        assert out["result"] == " ".join(map(str, port_refs[0]))
        assert out["generated_tokens"] == MAX_NEW
        assert out["finish_reason"] == "length"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"input_text": " ".join(["3"] * 17)})
        assert exc.value.code == 413
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"input_text": "5", "max_new_tokens": 0})
        assert exc.value.code == 422
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["completed"] == 1 and stats["kv_layout"] == "paged"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read())["ready"] is True
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def test_main_serves_from_a_config(tmp_path):
    """``python -m fengshen_tpu_torch.api.main --config`` on port 0: it
    prints the bound port, answers a POST, and stops on SIGTERM."""
    LlamaConfig(**CFG).save_pretrained(str(tmp_path / "model"))
    cfg_path = tmp_path / "server.json"
    cfg_path.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "device": "cpu"},
        "ENGINE": {"num_slots": 2, "buckets": [8]},
        "PIPELINE": {"task": "text_generation",
                     "model": str(tmp_path / "model"), "seed": 3,
                     "max_new_tokens": 4}}))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "fengshen_tpu_torch.api.main", "--config",
         str(cfg_path)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while "listening on" not in line:
            line = lines.get(timeout=120)   # raises queue.Empty on a hang
        port = int(line.rsplit(":", 1)[1])
        out = _post(port, {"input_text": "5 7 9"})
        assert out["generated_tokens"] == 4
        assert len(out["result"].split()) == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
