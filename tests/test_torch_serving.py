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
- The port's int8-KV engine (slot and paged) against the JAX package's
  int8-KV engine on the tiny model and prompts of
  ``tests/test_serving_paged.py``, token for token, and against the
  port's own unquantized pool with the reference's margin-aware bar (a
  disagreement only where the fp top-2 gap is within 4x the measured
  int8 round-trip noise).
- ``BlockAllocator`` accounting, the engine's config gates, and one
  HTTP round trip through ``build_stdlib_server`` on ``127.0.0.1:0``.
- Speculative serving (``prompt_lookup`` and ``self_draft``; slot and
  paged; fp32 and int8 pools) against the port's non-spec engine and the
  JAX package's spec engine, token for token, with staggered admission
  and eos; the gamma headroom at admission, the paged charge, a tight
  pool, the ``/stats`` keys (mirroring ``tests/test_serving_spec.py``);
  ``EngineConfig`` raising where the reference's raises.
- Sampling: a lane's tokens depend only on the engine seed and its
  request seed (or id), never on its slot, admission order or
  co-tenants; the logits controls against the JAX engine; sampling and
  spec settings from a server config file over HTTP.
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
from fengshen_tpu_torch.models.llama.modeling_llama import KVCache
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


#: the int8 comparison's model, prompts and engine: those of
#: tests/test_serving_paged.py (``_make``, ``_prompts(..., seed=11)``,
#: ``test_int8_kv_margin_aware_agreement``)
INT8_CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, dtype="float32")
INT8_LAYOUTS = {"paged": dict(kv_layout="paged", kv_block_size=16),
                "slot": {}}


def _int8_engine_config(layout, kv_dtype="int8"):
    return dict(num_slots=2, buckets=(8, 16), max_new_tokens=10,
                max_queue=16, kv_dtype=kv_dtype, **INT8_LAYOUTS[layout])


@pytest.fixture(scope="module")
def jax_int8():
    """The JAX package's int8-KV engine on its tiny model: params and the
    tokens each layout serves."""
    from fengshen_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from fengshen_tpu.serving import EngineConfig as JaxEngineConfig
    model = JaxLlama(JaxLlamaConfig(**INT8_CFG))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4), jnp.int32))["params"]
    prompts = _prompts((5, 11, 16, 7), seed=11)
    served = {layout: JaxEngine(model, params, JaxEngineConfig(
        **_int8_engine_config(layout))).generate_all(prompts)
        for layout in INT8_LAYOUTS}
    return jax.tree_util.tree_map(np.asarray, params), served


@pytest.fixture(scope="module")
def int8_model(jax_int8):
    cfg = LlamaConfig(**INT8_CFG)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax_int8[0], cfg))
    return model


def _kv_roundtrip_noise(model, seq):
    """The int8-KV logit perturbation, measured as the reference's
    ``_kv_roundtrip_noise`` does: prime a cache on ``seq[:-1]``, round
    its K/V through the pool's per-(token, head) quantization, decode
    one step both ways, and return the max |logit| difference."""
    from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv, quantize_kv
    from fengshen_tpu_torch.utils.generate import _prefill_cache
    ids = torch.tensor(np.asarray(seq[:-1]), dtype=torch.long)[None]
    mask = torch.ones_like(ids)
    _, cache = _prefill_cache(model, ids, mask,
                              torch.arange(ids.shape[1])[None])

    def step(roundtrip):
        c = KVCache([t.clone() for t in cache.keys],
                    [t.clone() for t in cache.values], cache.index)
        if roundtrip:
            c.keys = [dequantize_kv(*quantize_kv(t), t.dtype) for t in c.keys]
            c.values = [dequantize_kv(*quantize_kv(t), t.dtype)
                        for t in c.values]
        with torch.no_grad():
            return model(torch.tensor([[int(seq[-1])]]),
                         attention_mask=mask,
                         position_ids=torch.tensor([[len(seq) - 1]]),
                         cache=c)[0, -1]
    return float((step(False) - step(True)).abs().max())


def _assert_margin_aware_agreement(model, prompt, ref_tokens, test_tokens,
                                   noise_scale=4.0):
    """The reference's bar (``tests/test_serving_paged.py:225-250``):
    only the first disagreement is judged, and there the fp top-2 gap of
    the teacher-forced forward must be within ``noise_scale`` x the
    measured round-trip noise."""
    assert len(ref_tokens) == len(test_tokens)
    for t, (a, b) in enumerate(zip(ref_tokens, test_tokens)):
        if a == b:
            continue
        seq = np.concatenate([prompt, ref_tokens[:t + 1]])
        with torch.no_grad():
            logits = model(torch.tensor(seq, dtype=torch.long)[None])[0]
        top2 = np.sort(logits[len(prompt) + t - 1].numpy())[-2:]
        margin = float(top2[1] - top2[0])
        noise = _kv_roundtrip_noise(model, seq[:len(prompt) + t])
        assert margin <= noise_scale * noise, (
            f"int8 KV flipped a confident position {t}: fp margin "
            f"{margin:.4f} vs noise floor {noise:.4f}")
        return


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_engine_matches_jax_int8_engine(jax_int8, int8_model, layout):
    """The port's int8 pool serves the JAX package's int8 tokens, and
    holds the margin-aware bar against its own unquantized pool; /stats
    reports the pool's bytes, values and scales."""
    prompts = _prompts((5, 11, 16, 7), seed=11)
    eng = ContinuousBatchingEngine(
        int8_model, EngineConfig(**_int8_engine_config(layout)),
        device="cpu")
    served = eng.generate_all(prompts)
    assert served == jax_int8[1][layout]
    stats = eng.stats()
    assert stats["kv_dtype"] == "int8"
    cfg = int8_model.config
    tokens = (eng.num_blocks * eng.block_size if layout == "paged"
              else 2 * cfg.max_position_embeddings)
    per_token = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * (
        cfg.head_dim + 4)                     # int8 values + fp32 scale
    assert stats["kv_cache_bytes"] == tokens * per_token
    fp = ContinuousBatchingEngine(
        int8_model, EngineConfig(**_int8_engine_config(layout, "fp32")),
        device="cpu").generate_all(prompts)
    for prompt, ref, out in zip(prompts, fp, served):
        _assert_margin_aware_agreement(int8_model, prompt, ref, out)


def test_int8_pool_served_over_http(jax_int8, int8_model):
    """An ENGINE section naming ``kv_dtype: "int8"`` (as a server config
    file gives it) serves the int8 tokens over HTTP, and /stats reports
    the int8 pool."""
    pipe = Pipeline(module=int8_model, tokenizer=IdTokenizer(),
                    max_new_tokens=10, device="cpu")
    engine = start_continuous_engine(pipe, _int8_engine_config("paged"))
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, device="cpu"),
        PipelineConfig(task="text_generation"), pipeline=pipe,
        engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        prompt = _prompts((5, 11, 16, 7), seed=11)[1]
        out = _post(port, {"input_text": " ".join(map(str, prompt))})
        assert out["result"] == " ".join(
            map(str, jax_int8[1]["paged"][1]))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert (stats["kv_dtype"], stats["kv_layout"]) == ("int8", "paged")
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)


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
    # sampling, the controls and both speculative modes construct; the
    # reference's ValueErrors hold
    for kw in (dict(spec_mode="prompt_lookup"), dict(do_sample=True),
               dict(repetition_penalty=1.2), dict(min_length=3),
               dict(spec_mode="self_draft", do_sample=True, top_k=5)):
        cfg = EngineConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    for kw, match in ((dict(spec_mode="prompt_lookup", do_sample=True),
                       "greedy-only"),
                      (dict(spec_mode="self_draft", min_length=3),
                       "logits controls"),
                      (dict(spec_mode="prompt_lookup", spec_gamma=0),
                       "spec_gamma")):
        with pytest.raises(ValueError, match=match):
            EngineConfig(**kw)
    assert EngineConfig(kv_dtype="int8").kv_dtype == "int8"
    with pytest.raises(ValueError):
        EngineConfig(kv_dtype="bf16")
    with pytest.raises(ValueError):
        EngineConfig(kv_layout="ring")


def test_reference_config_fields_all_load():
    """Every field of the reference's ``EngineConfig`` and
    ``ServerConfig`` is a field of the port's; the reference's defaults
    load, the speculative knobs load at any valid value, and a value
    other than the default of a feature the port lacks raises
    ``NotImplementedError`` (never ``TypeError``)."""
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
               dict(spec_draft_layers=4)):
        assert dataclasses.asdict(EngineConfig(**kw)).items() >= kw.items()
    for kw in (dict(debug_ring=8), dict(journal_ring=16)):
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


# -- speculative serving (mirroring tests/test_serving_spec.py) ------------

SPEC_MODES = {"prompt_lookup": dict(spec_mode="prompt_lookup", spec_gamma=4),
              "self_draft": dict(spec_mode="self_draft", spec_gamma=4,
                                 spec_draft_layers=1)}
SPEC_POOLS = {"slot-fp32": {}, "paged-fp32": dict(kv_layout="paged",
                                                  kv_block_size=8),
              "slot-int8": dict(kv_dtype="int8"),
              "paged-int8": dict(kv_layout="paged", kv_block_size=8,
                                 kv_dtype="int8")}


def _rep_prompts(n, length, seed=0):
    """Short-period prompts: the workload lookup drafts for."""
    rng = np.random.RandomState(seed)
    return [np.tile(rng.randint(3, 96, 3).astype(np.int32),
                    length)[:length] for _ in range(n)]


def _staggered(eng, prompts):
    """Two requests, three ticks, then the rest (slot reclaim on the way)."""
    reqs = [eng.submit(p) for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p) for p in prompts[2:]]
    eng.run_until_idle()
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def spec_workload(port_refs):
    """Prompts of both buckets plus repetitive ones, and an eos that the
    greedy stream of prompt 1 meets at its fourth token."""
    return _prompts() + _rep_prompts(2, 14, seed=2), port_refs[1][3]


@pytest.mark.parametrize("pool", list(SPEC_POOLS))
@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_spec_engine_matches_jax_and_nonspec(jax_side, port_model,
                                             spec_workload, mode, pool):
    """Both speculative modes, every pool: the port's spec engine serves
    the port's non-spec engine's tokens and the JAX spec engine's, with
    staggered admission, slot reclaim and eos inside a window."""
    from fengshen_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from fengshen_tpu.serving import EngineConfig as JaxEngineConfig
    prompts, eos = spec_workload
    kw = dict(num_slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW,
              max_queue=16, eos_token_id=eos, **SPEC_POOLS[pool])
    spec = ContinuousBatchingEngine(
        port_model, EngineConfig(**kw, **SPEC_MODES[mode]), device="cpu")
    served = _staggered(spec, prompts)
    base = _staggered(ContinuousBatchingEngine(
        port_model, EngineConfig(**kw), device="cpu"), prompts)
    assert served == base
    jax_model = JaxLlama(JaxLlamaConfig(**CFG))
    want = _staggered(JaxEngine(jax_model, jax_side[0], JaxEngineConfig(
        **kw, **SPEC_MODES[mode])), prompts)
    assert served == want
    assert served[1][-1] == eos and len(served[1]) == 4
    st = spec.stats()
    assert st["completed"] == len(prompts) and st["slots_active"] == 0
    assert st["spec_mode"] == mode and st["kv_blocks_used"] == 0


def test_spec_engine_accepts_drafts_on_repetitive_prompts(port_model):
    """Lookup proposals are accepted on looping text (else the parity
    above would be all corrections); fewer verify ticks than tokens."""
    prompts = _rep_prompts(3, 14, seed=2)
    refs = [generate(port_model, p[None], max_new_tokens=24,
                     device="cpu")[0, len(p):].tolist() for p in prompts]
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=3, buckets=(16,),
                                 max_new_tokens=24, max_queue=8,
                                 **SPEC_MODES["prompt_lookup"]),
        device="cpu")
    assert eng.generate_all(prompts) == refs
    st = eng.stats()
    assert st["spec_accepted_total"] > 0
    assert 0.0 < st["spec_acceptance_rate"] <= 1.0
    assert st["decode_ticks"] < st["decode_tokens"]


def test_spec_headroom_boundary_rejects_413(port_model):
    """Capacity 64, bucket 60, gamma 4: no decode room, so the spec engine
    answers 413 where the non-spec engine admits; one bucket lower the
    spec engine clamps max_new to 64 - 56 - 4 = 4 (``:212``)."""
    lookup = SPEC_MODES["prompt_lookup"]
    prompt = _prompts((58,), seed=5)[0]
    kw = dict(num_slots=1, buckets=(8, 56, 60), max_new_tokens=8,
              max_queue=4)
    eng = ContinuousBatchingEngine(port_model, EngineConfig(**kw, **lookup),
                                   device="cpu")
    with pytest.raises(PromptTooLong, match="gamma=4"):
        eng.submit(prompt)
    assert eng.stats()["rejected_prompt_too_long"] == 1
    off = ContinuousBatchingEngine(port_model, EngineConfig(**kw),
                                   device="cpu")
    req = off.submit(prompt)
    off.run_until_idle()
    assert req.state == "finished"
    short = _prompts((50,), seed=6)[0]
    req = eng.submit(short, max_new_tokens=8)
    eng.run_until_idle()
    assert req.state == "finished"
    assert req.tokens == generate(port_model, short[None], max_new_tokens=4,
                                  device="cpu")[0, 50:].tolist()
    with pytest.raises(ValueError, match="gamma=4"):
        ContinuousBatchingEngine(port_model, EngineConfig(
            buckets=(60,), **lookup), device="cpu")


def test_spec_paged_charge_includes_gamma(port_model):
    """ceil((bucket 8 + max_new 8 + gamma 4) / 16) = 2 blocks, where the
    non-spec charge is 1 (``:241``); a pool of one usable block rejects
    the spec request at submit and serves the non-spec one."""
    kw = dict(num_slots=2, buckets=(8,), max_new_tokens=8, max_queue=8,
              kv_layout="paged", kv_block_size=16)
    for spec, want in ((SPEC_MODES["prompt_lookup"], 2), ({}, 1)):
        eng = ContinuousBatchingEngine(
            port_model, EngineConfig(**kw, kv_num_blocks=6, **spec),
            device="cpu")
        eng.submit(_prompts((6,), seed=7)[0])
        eng.step()
        assert eng.stats()["kv_blocks_used"] == want
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(**kw, kv_num_blocks=2,
                                 **SPEC_MODES["self_draft"]), device="cpu")
    with pytest.raises(PromptTooLong, match="KV blocks"):
        eng.submit(_prompts((6,))[0])


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_spec_paged_tight_pool_no_cross_lane_corruption(port_model, mode):
    """Three lanes on a pool of exactly their charged blocks (3 each of
    8 tokens): a rejected tail written across a block edge into a
    neighbour's block would change its tokens (``:265``)."""
    prompts = _rep_prompts(3, 8, seed=8)
    refs = [generate(port_model, p[None], max_new_tokens=12,
                     device="cpu")[0, 8:].tolist() for p in prompts]
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=3, buckets=(8,),
                                 max_new_tokens=12, max_queue=8,
                                 kv_layout="paged", kv_block_size=8,
                                 kv_num_blocks=10, **SPEC_MODES[mode]),
        device="cpu")
    assert eng.generate_all(prompts) == refs
    assert eng.stats()["kv_blocks_used"] == 0


SPEC_STATS = {"spec_mode", "spec_gamma", "spec_drafted_total",
              "spec_accepted_total", "spec_acceptance_rate"}


def test_spec_stats_keys_and_nonspec_shape_unchanged(port_model):
    """The spec engine's /stats is the non-spec payload plus exactly the
    five spec keys (``:329``); the non-spec payload has none of them."""
    kw = dict(num_slots=2, buckets=(16,), max_new_tokens=16, max_queue=4)
    prompts = _rep_prompts(2, 12, seed=9)
    off = ContinuousBatchingEngine(port_model, EngineConfig(**kw),
                                   device="cpu")
    off.generate_all(prompts)
    spec = ContinuousBatchingEngine(
        port_model, EngineConfig(**kw, **SPEC_MODES["prompt_lookup"]),
        device="cpu")
    spec.generate_all(prompts)
    plain, st = off.stats(), spec.stats()
    assert not SPEC_STATS & set(plain)
    assert set(st) == set(plain) | SPEC_STATS
    assert st["spec_mode"] == "prompt_lookup" and st["spec_gamma"] == 4
    assert st["spec_drafted_total"] > 0
    assert 0 <= st["spec_accepted_total"] <= st["spec_drafted_total"]
    assert st["spec_acceptance_rate"] == pytest.approx(
        st["spec_accepted_total"] / st["spec_drafted_total"])


CONFIG_GRID = [dict(), dict(do_sample=True, top_k=4),
               dict(spec_mode="prompt_lookup"),
               dict(spec_mode="prompt_lookup", do_sample=True),
               dict(spec_mode="self_draft", do_sample=True, top_p=0.9),
               dict(spec_mode="self_draft", spec_draft_layers=0),
               dict(spec_mode="prompt_lookup", spec_ngram=0),
               dict(spec_mode="self_draft", spec_gamma=0),
               dict(spec_mode="prompt_lookup", repetition_penalty=1.2),
               dict(spec_mode="self_draft", no_repeat_ngram_size=1),
               dict(spec_mode="prompt_lookup", min_length=4),
               dict(repetition_penalty=1.2, no_repeat_ngram_size=1,
                    min_length=4, do_sample=True),
               dict(no_repeat_ngram_size=2), dict(spec_mode="lookup"),
               dict(spec_mode="off", spec_gamma=0)]


@pytest.mark.parametrize("kw", CONFIG_GRID, ids=str)
def test_engine_config_validates_as_the_reference(kw):
    """Wherever the reference's ``EngineConfig`` constructs the port's
    does, and wherever it raises ``ValueError`` the port's raises it."""
    from fengshen_tpu.serving import EngineConfig as JaxEngineConfig
    try:
        JaxEngineConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    else:
        EngineConfig(**kw)


# -- sampling and the logits controls -----------------------------------------

SAMPLED = {"off": dict(do_sample=True, temperature=0.8, top_k=6),
           "self_draft": dict(do_sample=True, temperature=0.8, top_p=0.9,
                              **SPEC_MODES["self_draft"])}


@pytest.mark.parametrize("mode", list(SAMPLED))
def test_sampled_lane_is_pure(port_model, mode):
    """A lane's sampled tokens depend only on the engine seed and the
    request's seed: served alone in one slot, or among others in another
    slot and admitted in another order (paged, reversed, staggered), the
    request draws the same tokens; an explicit seed is the id's default
    and another seed draws others."""
    prompts = _prompts() + _rep_prompts(2, 14, seed=3)
    ids = [f"r{i}" for i in range(len(prompts))]
    kw = dict(buckets=(8, 16), max_new_tokens=MAX_NEW, max_queue=16,
              seed=3, **SAMPLED[mode])
    crowd = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=3, **kw), device="cpu")
    reqs = {i: crowd.submit(p, request_id=i) for i, p in zip(ids, prompts)}
    crowd.run_until_idle()
    served = {i: r.tokens for i, r in reqs.items()}
    assert len({tuple(t) for t in served.values()}) == len(prompts)
    paged = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, kv_layout="paged",
                                 kv_block_size=8, **kw), device="cpu")
    late = {}
    for i, p in reversed(list(zip(ids, prompts))):
        late[i] = paged.submit(p, request_id=i)
        paged.step()
    paged.run_until_idle()
    assert {i: r.tokens for i, r in late.items()} == served
    alone = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=1, **kw), device="cpu")
    import zlib
    seeded = alone.submit(prompts[4],
                          seed=zlib.crc32(ids[4].encode()) & 0x7FFFFFFF)
    other = alone.submit(prompts[4], seed=12345)
    alone.run_until_idle()
    assert seeded.tokens == served[ids[4]]
    assert other.tokens != served[ids[4]]


def test_sampled_tokens_lie_in_the_top_k(port_model):
    """Every sampled token is among its step's top-k logits (re-scored by
    one cacheless forward over the bucket-padded sequence)."""
    from fengshen_tpu_torch.serving import BucketLadder
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, buckets=(16,),
                                 max_new_tokens=MAX_NEW, **SAMPLED["off"]),
        device="cpu")
    prompts = _prompts()
    ladder = BucketLadder((16,))
    for prompt, tokens in zip(prompts, eng.generate_all(prompts)):
        row, mask = ladder.pad_prompt(prompt, 16)
        ids = torch.tensor(list(row) + tokens[:-1])[None]
        m = torch.tensor(list(mask) + [1] * (len(tokens) - 1))[None]
        with torch.no_grad():
            logits = port_model(ids, attention_mask=m,
                                position_ids=(m.cumsum(-1) - 1).clamp(
                                    min=0))[0, 15:]
        kth = logits.topk(6, dim=-1).values[:, -1]
        chosen = logits.gather(1, torch.tensor(tokens)[:, None])[:, 0]
        assert bool((chosen >= kth - 1e-5).all())


@pytest.mark.parametrize("controls", [
    dict(repetition_penalty=1.8), dict(no_repeat_ngram_size=1),
    dict(min_length=24, eos_token_id=None),
    dict(repetition_penalty=1.3, no_repeat_ngram_size=1)], ids=str)
def test_controls_engine_matches_jax_engine(jax_side, port_model,
                                            port_refs, controls):
    """The logits controls in the engine (per-lane history, cursors and
    left-padded prompt masks) serve the JAX engine's tokens; min_length
    holds eos off until the full sequence reaches it."""
    from fengshen_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from fengshen_tpu.serving import EngineConfig as JaxEngineConfig
    controls = dict(controls)
    if "eos_token_id" in controls:
        controls["eos_token_id"] = port_refs[1][1]
    kw = dict(num_slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW,
              max_queue=16, **controls)
    prompts = _prompts() + _rep_prompts(1, 14, seed=2)
    served = _staggered(ContinuousBatchingEngine(
        port_model, EngineConfig(**kw), device="cpu"), prompts)
    want = _staggered(JaxEngine(JaxLlama(JaxLlamaConfig(**CFG)),
                                jax_side[0], JaxEngineConfig(**kw)),
                      prompts)
    assert served == want
    if "min_length" in controls:
        assert served[1] != port_refs[1]
    if controls.get("no_repeat_ngram_size") == 1:
        for prompt, tokens in zip(prompts, served):
            assert not set(tokens) & set(prompt.tolist())
            assert len(set(tokens)) == len(tokens)


def test_sampled_spec_served_from_a_config_over_http(tmp_path, jax_side):
    """PIPELINE sampling settings and ENGINE spec fields from a server
    config file reach the engine; a request's ``request_id`` sets its
    seed, so the same id draws the same tokens; /stats shows the spec
    section."""
    from fengshen_tpu_torch.api.main import (_resolve_pipeline,
                                             create_continuous_engine,
                                             load_config)
    LlamaConfig(**CFG).save_pretrained(str(tmp_path / "model"))
    path = tmp_path / "server.json"
    path.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "device": "cpu"},
        "ENGINE": {"num_slots": 2, "buckets": [16], "spec_mode":
                   "self_draft", "spec_gamma": 3, "spec_draft_layers": 1},
        "PIPELINE": {"task": "text_generation",
                     "model": str(tmp_path / "model"), "seed": 3,
                     "max_new_tokens": 8, "do_sample": True,
                     "temperature": 0.7, "top_k": 5}}))
    server_cfg, pipe_cfg = load_config(str(path))
    pipe = _resolve_pipeline(pipe_cfg, server_cfg.device)
    engine = create_continuous_engine(pipe, server_cfg.engine_args)
    cfg = engine.config
    assert (cfg.do_sample, cfg.top_k, cfg.temperature, cfg.seed) == \
        (True, 5, 0.7, 3)
    assert (cfg.spec_mode, cfg.spec_gamma) == ("self_draft", 3)
    engine.warmup()
    engine.start()
    server = build_stdlib_server(server_cfg, pipe_cfg, pipeline=pipe,
                                 engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        text = " ".join(map(str, _prompts()[2]))
        a = _post(port, {"input_text": text, "request_id": "same"})
        b = _post(port, {"input_text": text, "request_id": "same"})
        c = _post(port, {"input_text": text, "request_id": "other"})
        assert a["result"] == b["result"] != c["result"]
        assert a["generated_tokens"] == 8
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["spec_mode"] == "self_draft"
        assert stats["spec_drafted_total"] > 0
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
