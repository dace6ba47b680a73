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
import signal
import subprocess
import sys
import threading
import time
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


#: the tiny BertTokenizer vocab the JAX pipeline tests build
#: (``tests/test_pipelines.py:14``): ids 0..36, inside every vocab here
TOKEN_CHARS = "今天天气很好坏非常糟糕开心难过测试句子北京上海人名地名"
TEXTS = ("今天天气很好", "北京上海人名地名测试", "开心", "非常糟糕难过坏句子")


def _bert_tokenizer(path):
    from transformers import BertTokenizer
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        sorted(set(TOKEN_CHARS))
    (path / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizer(str(path / "vocab.txt"))


def write_checkpoint(path, config, state_dict, fmt="safetensors",
                     shards=2, tokenizer=True):
    """An HF-style checkpoint directory: ``config.json``, the state dict
    in ``shards`` files (``safetensors`` through the package's
    ``safetensors.torch.save_file``, or ``bin`` through ``torch.save``)
    and, with ``tokenizer``, the tiny BertTokenizer's files."""
    from safetensors.torch import save_file
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(str(path))
    sd = {k: v.detach().cpu().contiguous().clone()
          for k, v in state_dict.items()}
    keys = sorted(sd)
    for i in range(shards):
        part = {k: sd[k] for k in keys[i::shards]}
        stem = f"{i + 1:05d}-of-{shards:05d}"
        if fmt == "safetensors":
            save_file(part, str(path / f"model-{stem}.safetensors"))
        else:
            torch.save(part, str(path / f"pytorch_model-{stem}.bin"))
    if tokenizer:
        _bert_tokenizer(path).save_pretrained(str(path))
    return path


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


def test_busy_engine_lets_blocked_callers_in_between_ticks(port_model,
                                                            monkeypatch):
    """A tick holds the engine's lock for its whole forward and the serve
    loop takes it again at once. Callers blocked on it (``stats``,
    ``submit``, the drain) must get it before the next tick, not once the
    engine is idle: each ``stats`` call here waits at most a few ticks of
    30 ms, where a lock that the loop always wins keeps it seconds."""
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(num_slots=2, buckets=(16,),
                                 max_new_tokens=40), device="cpu")
    tick = eng._decode_tick

    def slow_tick():
        time.sleep(0.03)        # a forward on the card: the GIL is free
        return tick()

    monkeypatch.setattr(eng, "_decode_tick", slow_tick)
    eng.start()
    waits = []
    try:
        req = eng.submit(_prompts()[0])
        while not req.done:
            t0 = time.perf_counter()
            active = eng.stats()["slots_active"]
            waits.append((time.perf_counter() - t0, active))
            time.sleep(0.005)
    finally:
        eng.stop()
    assert req.state == "finished" and len(req.tokens) == 40
    # most calls land while the lane decodes, none after a long wait
    assert sum(a for _, a in waits) >= 10, waits
    assert max(w for w, _ in waits) < 0.3, waits

def test_reference_config_fields_all_load():
    """Every field of the reference's ``EngineConfig`` and
    ``ServerConfig`` is a field of the port's; the reference's defaults
    load (its ``engine`` "simple" among them), the speculative knobs,
    ``debug_ring``, ``journal_ring``, ``drain_timeout_s``, ``dump_dir``,
    ``log_level`` and ``engine="simple"`` load at any valid value, and a
    value other than the default of a feature the port lacks (``phase``,
    ``peers``, ``aot_args``) raises ``NotImplementedError`` (never
    ``TypeError``)."""
    import dataclasses

    from fengshen_tpu.api.main import ServerConfig as JaxServerConfig
    from fengshen_tpu.serving.engine import EngineConfig as JaxEngineConfig
    for ref_cls, port_cls in ((JaxEngineConfig, EngineConfig),
                              (JaxServerConfig, ServerConfig)):
        ref = {f.name for f in dataclasses.fields(ref_cls)}
        port = {f.name for f in dataclasses.fields(port_cls)}
        assert ref <= port, sorted(ref - port)
    EngineConfig(**dataclasses.asdict(JaxEngineConfig()))
    assert ServerConfig(**dataclasses.asdict(JaxServerConfig())).engine == \
        "simple"
    for kw in (dict(spec_gamma=6), dict(spec_ngram=3),
               dict(spec_draft_layers=4), dict(debug_ring=8),
               dict(journal_ring=16)):
        assert dataclasses.asdict(EngineConfig(**kw)).items() >= kw.items()
    for kw in (dict(debug_ring=0), dict(journal_ring=0)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    for kw in (dict(drain_timeout_s=5.0), dict(dump_dir="/tmp/x"),
               dict(log_level="debug"), dict(engine="simple"),
               dict(engine="continuous")):
        assert dataclasses.asdict(ServerConfig(**kw)).items() >= kw.items()
    for kw in (dict(phase="prefill"), dict(peers=("http://a:1",)),
               dict(aot_args={"cache_dir": "d"}),
               dict(engine="batch_image")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ServerConfig(**kw)
    with pytest.raises(ValueError):
        ServerConfig(engine="fast")


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


def test_main_serves_from_a_config(tmp_path, port_model):
    """``python -m fengshen_tpu_torch.api.main --config`` on port 0 over a
    checkpoint directory (weights and tokenizer): it prints the bound
    port, answers ``/healthz`` 200 once warm and a POST, and on SIGTERM
    drains and exits 0, leaving its drain bundle in ``dump_dir``. The one
    test that sends a real SIGTERM, to its own subprocess."""
    model_dir = write_checkpoint(tmp_path / "model", port_model.config,
                                 port_model.state_dict())
    cfg_path = tmp_path / "server.json"
    cfg_path.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "device": "cpu",
                   "engine": "continuous", "drain_timeout_s": 20,
                   "dump_dir": str(tmp_path / "dumps")},
        "ENGINE": {"num_slots": 2, "buckets": [8, 16]},
        "PIPELINE": {"task": "text_generation", "model": str(model_dir),
                     "seed": 3, "max_new_tokens": 4}}))
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
        _wait_ready(port)
        out = _post(port, {"input_text": TEXTS[0]})
        assert out["generated_tokens"] == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    bundles = sorted(p.name for p in (tmp_path / "dumps").iterdir())
    assert bundles and bundles[-1].endswith("sigterm_drain")


def _wait_ready(port, timeout=120.0):
    """Poll ``/healthz`` until it answers 200."""
    import time
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=10) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if time.monotonic() > deadline:
                raise AssertionError(f"never ready: {e.read()!r}") from e
            time.sleep(0.1)


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
    assert st["spec_acceptance_rate"] == round(
        st["spec_accepted_total"] / st["spec_drafted_total"], 4)


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


def test_sampled_spec_served_from_a_config_over_http(tmp_path, port_model):
    """PIPELINE sampling settings (``seed`` the sampling seed, as in the
    reference) and ENGINE spec fields from a server config file over a
    checkpoint directory reach the engine; a request's ``request_id``
    sets its seed, so the same id draws the same tokens; /stats shows
    the spec section."""
    from fengshen_tpu_torch.api.main import (_resolve_pipeline,
                                             create_continuous_engine,
                                             load_config)
    model_dir = write_checkpoint(tmp_path / "model", port_model.config,
                                 port_model.state_dict())
    path = tmp_path / "server.json"
    path.write_text(json.dumps({
        "SERVER": {"host": "127.0.0.1", "port": 0, "device": "cpu",
                   "engine": "continuous"},
        "ENGINE": {"num_slots": 2, "buckets": [16], "spec_mode":
                   "self_draft", "spec_gamma": 3, "spec_draft_layers": 1},
        "PIPELINE": {"task": "text_generation", "model": str(model_dir),
                     "seed": 3, "max_new_tokens": 8, "do_sample": True,
                     "temperature": 0.7, "top_k": 5}}))
    server_cfg, pipe_cfg = load_config(str(path))
    pipe = _resolve_pipeline(pipe_cfg, server_cfg.device)
    assert pipe.seed == 3
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
        text = TEXTS[1]
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


# -- the serving surface: journal, streams, resume, timelines, drain ----------

SURFACE_LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged",
                                             kv_block_size=8)}
#: the resumed request: prompt 0's first RESUME_K tokens are carried
RESUME_K = 4


def _surface_config(layout, **kw):
    return dict(num_slots=2, buckets=(8, 16), max_new_tokens=MAX_NEW,
                max_queue=16, **SURFACE_LAYOUTS[layout], **kw)


def _drive_surface(eng, errors):
    """The same request sequence on either package's engine: four
    streamed requests (staggered, through a pool of two lanes), their
    stream events, journal entries and timelines; a resume of request 0
    from its first RESUME_K tokens; then a drain with one lane running
    and one queued, and the refusals around it. Returns what each step
    gave, in plain Python values."""
    prompts = _prompts()
    ids = [f"s{i}" for i in range(len(prompts))]
    reqs = [eng.submit(p, request_id=i, stream=True)
            for p, i in zip(prompts[:2], ids)]
    for _ in range(3):
        eng.step()
    with pytest.raises(errors["DuplicateRequest"]):
        eng.submit(prompts[0], request_id=ids[0])
    reqs += [eng.submit(p, request_id=i, stream=True)
             for p, i in zip(prompts[2:], ids[2:])]
    eng.run_until_idle()
    out = {"tokens": [r.tokens for r in reqs],
           "events": [list(eng.streams.get(i).events(0, timeout=5))
                      for i in ids],
           "partial": [eng.partial(i) for i in ids],
           "debug": eng.debug_request(ids[0]),
           "debug_list": eng.debug_requests()}
    resumed = eng.submit(prompts[0], request_id="resumed",
                         resume_tokens=reqs[0].tokens[:RESUME_K],
                         resume_source="test", stream=True)
    eng.run_until_idle()
    out["resumed"] = resumed.tokens
    out["resumed_partial"] = eng.partial("resumed")
    out["resumed_events"] = list(
        eng.attach_stream("resumed").events(RESUME_K - 1, timeout=5))
    drained = [eng.submit(p, request_id=f"d{i}")
               for i, p in enumerate(prompts[:3])]
    eng.step()
    eng.begin_drain()
    with pytest.raises(errors["Draining"]):
        eng.submit(prompts[3])
    assert not eng.idle() and eng.draining
    live = eng.live_lane_ids()
    eng.run_until_idle()
    out["drain"] = dict(live=live, idle=eng.idle(),
                        states=[(r.state, r.finish_reason, len(r.tokens))
                                for r in drained])
    out["stats"] = eng.stats()
    return out


@pytest.fixture(scope="module")
def jax_surface(jax_side):
    """The JAX engine's answers to :func:`_drive_surface`, per layout."""
    from fengshen_tpu.serving import ContinuousBatchingEngine as JaxEngine
    from fengshen_tpu.serving import Draining as JaxDraining
    from fengshen_tpu.serving import DuplicateRequest as JaxDuplicate
    from fengshen_tpu.serving import EngineConfig as JaxEngineConfig
    model = JaxLlama(JaxLlamaConfig(**CFG))
    return {layout: _drive_surface(
        JaxEngine(model, jax_side[0],
                  JaxEngineConfig(**_surface_config(layout))),
        {"Draining": JaxDraining, "DuplicateRequest": JaxDuplicate})
        for layout in SURFACE_LAYOUTS}


def _event_names(d):
    return [e["event"] for e in d["events"]]


@pytest.mark.parametrize("layout", list(SURFACE_LAYOUTS))
def test_engine_surface_matches_jax(jax_surface, port_model, port_refs,
                                    layout):
    """Greedy, slot and paged: streamed tokens equal the blocking ones
    (``generate``'s) and the JAX engine's, event for event; ``partial``
    equals the JAX ``partial`` (but for the measured ``ttft_s``); the
    ``resume_tokens`` tail equals the uninterrupted run and the JAX
    engine's resume; the timelines have the reference's keys and event
    names; a live duplicate id raises ``DuplicateRequest``;
    ``begin_drain`` makes ``submit`` raise ``Draining``, flushes the
    queue and lets the running lanes finish."""
    from fengshen_tpu_torch.serving import Draining, DuplicateRequest
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(**_surface_config(layout)), device="cpu")
    got = _drive_surface(eng, {"Draining": Draining,
                               "DuplicateRequest": DuplicateRequest})
    want = jax_surface[layout]
    assert got["tokens"] == port_refs == want["tokens"]
    assert got["events"] == want["events"]
    for tokens, events in zip(got["tokens"], got["events"]):
        assert [e[2] for e in events[:-1]] == tokens
        assert events[-1] == ("done", len(tokens), "length")
    for mine, theirs in zip(got["partial"] + [got["resumed_partial"]],
                            want["partial"] + [want["resumed_partial"]]):
        assert mine.keys() == theirs.keys()
        assert {k: v for k, v in mine.items() if k != "ttft_s"} == \
            {k: v for k, v in theirs.items() if k != "ttft_s"}
    assert got["resumed"] == got["tokens"][0] == want["resumed"]
    assert got["resumed_partial"]["resumed_tokens"] == RESUME_K
    assert got["resumed_events"] == want["resumed_events"]
    assert got["resumed_events"][0] == ("token", RESUME_K - 1,
                                        got["tokens"][0][RESUME_K - 1])
    assert got["debug"].keys() == want["debug"].keys()
    assert _event_names(got["debug"]) == _event_names(want["debug"])
    assert got["debug"]["phases"].keys() == want["debug"]["phases"].keys()
    assert got["debug_list"].keys() == want["debug_list"].keys()
    for key in ("in_flight", "recent"):
        assert [sorted(r) for r in got["debug_list"][key]] == \
            [sorted(r) for r in want["debug_list"][key]]
    assert got["drain"] == want["drain"]
    assert [s[:2] for s in got["drain"]["states"]] == [
        ("finished", "length"), ("finished", "length"),
        ("rejected", "draining")]
    assert set(want["stats"]) <= set(got["stats"])
    for key in ("admitted", "completed", "rejected_draining",
                "rejected_duplicate", "decode_ticks", "decode_tokens",
                "prefills_per_bucket", "streams_active", "draining"):
        assert got["stats"][key] == want["stats"][key], key


def test_engine_resume_validates_as_the_reference(port_model, port_refs):
    """A resume that leaves nothing to decode raises ``ValueError``; the
    resumed prefix counts toward ``max_new_tokens`` and toward the
    bucket (prompt 16 + 3 carried tokens needs a bucket the ladder lacks,
    413); a resume one token short of the end decodes exactly one."""
    eng = ContinuousBatchingEngine(
        port_model, EngineConfig(**_surface_config("slot")), device="cpu")
    prompts = _prompts()
    with pytest.raises(ValueError, match="nothing to decode"):
        eng.submit(prompts[0], resume_tokens=port_refs[0])
    with pytest.raises(PromptTooLong):
        eng.submit(prompts[2], resume_tokens=port_refs[2][:4])
    req = eng.submit(prompts[0], resume_tokens=port_refs[0][:-1])
    eng.run_until_idle()
    assert req.tokens == port_refs[0]
    assert eng.stats()["decode_ticks"] == 1


# -- checkpoint directories ---------------------------------------------------

@pytest.fixture(scope="module")
def tied_params():
    """Seeded numpy params of the tied-head variant of CFG (the JAX
    package's init, as ``jax_side`` makes the untied ones)."""
    model = JaxLlama(JaxLlamaConfig(**CFG, tie_word_embeddings=True))
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 4), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _ckpt_params(tied, jax_side, tied_params):
    return (tied_params if tied else jax_side[0]), \
        LlamaConfig(**CFG, tie_word_embeddings=tied)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin", "both"])
def test_load_hf_pretrained_matches_jax(tmp_path, jax_side, tied_params,
                                        fmt, tied):
    """``load_hf_pretrained`` reads safetensors shards, ``.bin`` shards,
    and a directory with both (the safetensors win: the ``.bin`` files
    there hold other weights). Every parameter equals the written tensor
    bitwise, and the port's logits equal the JAX package's from its own
    ``load_hf_pretrained`` on the same directory within 1e-5."""
    from fengshen_tpu.models.llama.convert import \
        load_hf_pretrained as jax_load
    from fengshen_tpu_torch.models.llama import load_hf_pretrained
    params, cfg = _ckpt_params(tied, jax_side, tied_params)
    state = params_from_jax(params, cfg)
    path = tmp_path / "ckpt"
    write_checkpoint(path, cfg, state, "bin" if fmt == "bin" else
                     "safetensors", tokenizer=False)
    if fmt == "both":
        write_checkpoint(path, cfg, {k: v + 1.0 for k, v in state.items()},
                         "bin", shards=1, tokenizer=False)
    config, model = load_hf_pretrained(str(path), device="cpu")
    assert config.tie_word_embeddings == tied
    assert (model.lm_head is None) == tied
    loaded = model.state_dict()
    assert loaded.keys() == state.keys()
    for name, tensor in state.items():
        assert torch.equal(loaded[name], tensor), name
    jcfg, jparams = jax_load(str(path))
    ids = np.asarray([_prompts()[1]])
    want = np.asarray(JaxLlama(jcfg).apply({"params": jparams},
                                           jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_load_hf_pretrained_refuses_what_it_cannot_load(tmp_path,
                                                        jax_side):
    """A directory with no weight files raises, naming the patterns it
    looked for; a missing, an unexpected or a misshapen tensor raises
    naming the tensor (and ``torch_to_params`` checks the same names,
    dropping a tied head's alias); HF's rotary ``inv_freq`` buffers are
    skipped; the port never makes weights from a seed instead."""
    from fengshen_tpu_torch.models.llama import (load_hf_pretrained,
                                                 torch_to_params)
    cfg = LlamaConfig(**CFG)
    state = params_from_jax(jax_side[0], cfg)
    empty = tmp_path / "empty"
    cfg.save_pretrained(str(empty))
    with pytest.raises(FileNotFoundError,
                       match=r"\*\.safetensors and pytorch_model\*\.bin"):
        load_hf_pretrained(str(empty), device="cpu")
    with pytest.raises(FileNotFoundError, match="no weights"):
        Pipeline(model=str(empty), tokenizer=IdTokenizer(), device="cpu")
    name = "model.layers.1.mlp.up_proj.weight"
    cases = {
        "missing": ({k: v for k, v in state.items() if k != name},
                    KeyError, name),
        "unexpected": ({**state, "model.layers.9.mlp.up_proj.weight":
                        state[name]}, KeyError, "layers.9"),
        "misshapen": ({**state, name: state[name][:, :3]}, ValueError,
                      name)}
    for case, (sd, err, match) in cases.items():
        path = write_checkpoint(tmp_path / case, cfg, sd, tokenizer=False)
        with pytest.raises(err, match=match):
            load_hf_pretrained(str(path), device="cpu")
        if err is KeyError:
            with pytest.raises(err, match=match):
                torch_to_params(sd, cfg)
    tied = LlamaConfig(**CFG, tie_word_embeddings=True)
    assert torch_to_params(state, tied).keys() == \
        state.keys() - {"lm_head.weight"}
    freq = write_checkpoint(
        tmp_path / "freq", cfg,
        {**state, "model.layers.0.self_attn.rotary_emb.inv_freq":
         torch.ones(4)}, "bin", tokenizer=False)
    _, model = load_hf_pretrained(str(freq), device="cpu")
    assert torch.equal(model.state_dict()[name], state[name])


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory, jax_side):
    """CFG's JAX weights as an HF checkpoint directory with the tiny
    BertTokenizer."""
    cfg = LlamaConfig(**CFG)
    return write_checkpoint(tmp_path_factory.mktemp("ckpt"), cfg,
                            params_from_jax(jax_side[0], cfg))


def test_pipeline_from_a_checkpoint_matches_jax(checkpoint_dir):
    """``Pipeline(model=dir)`` loads the weights and the tokenizer
    (``AutoTokenizer``) as the JAX pipeline does: the same encode and
    decode, the same greedy text from the one-request path, which the
    continuous engine serves too; ``generate_ids`` counts only real
    tokens (up to eos) into the global counter."""
    from fengshen_tpu.pipelines.text_generation import \
        Pipeline as JaxPipeline
    from fengshen_tpu_torch.observability import get_registry
    mine = Pipeline(model=str(checkpoint_dir), max_new_tokens=6,
                    device="cpu")
    ref = JaxPipeline(model=str(checkpoint_dir), max_new_tokens=6)
    for text in TEXTS:
        assert mine.encode(text).tolist() == ref.encode(text).tolist()
        ids = mine.encode(text)
        assert mine.decode(ids) == ref.decode(ids)
    texts = [mine(t) for t in TEXTS]
    assert texts == [ref(t) for t in TEXTS]
    engine = ContinuousBatchingEngine(
        mine.module, EngineConfig(**mine.engine_config_kwargs(),
                                  num_slots=2, buckets=(8, 16)),
        device="cpu")
    served = engine.generate_all([mine.encode(t) for t in TEXTS])
    assert [mine.decode(t) for t in served] == texts
    counter = get_registry().counter(
        "fstpu_pipeline_generated_tokens_total",
        "tokens generated by the legacy batch-1 pipeline path")
    first = mine.generate_ids(mine.encode(TEXTS[0]), 6)
    mine.eos_token_id = first[2]
    before = counter.value()
    out = mine.generate_ids(mine.encode(TEXTS[0]), 6)
    assert len(out) == 6 and counter.value() - before == 3


def test_tokenizer_path_needs_transformers(checkpoint_dir, monkeypatch):
    """Without ``transformers`` the tokenizer of a checkpoint directory
    raises ``ImportError`` naming it (never falls back to
    ``IdTokenizer``); an injected tokenizer needs no ``transformers``."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers'"):
        Pipeline(model=str(checkpoint_dir), device="cpu")
    pipe = Pipeline(model=str(checkpoint_dir), tokenizer=IdTokenizer(),
                    device="cpu")
    assert isinstance(pipe.tokenizer, IdTokenizer)


# -- the HTTP surface ---------------------------------------------------------

class _Served:
    """A stdlib server on 127.0.0.1:0 in a thread; ``close()`` shuts it
    down and stops the engine."""

    def __init__(self, build, server_cfg, pipeline, engine, **kw):
        self.server = build(server_cfg, PipelineConfig(
            task="text_generation"), pipeline=pipeline, engine=engine, **kw)
        self.engine = engine
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if self.engine is not None:
            self.engine.stop()
        self.thread.join(timeout=10)


def _local(**kw):
    return ServerConfig(host="127.0.0.1", port=0, device="cpu", **kw)


def _get(port, path, timeout=30):
    """(status, body) of a GET; JSON bodies parsed."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            code, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    return code, (json.loads(raw) if "json" in ctype else raw.decode())


def _post_status(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(port, payload, headers=None, limit=None, timeout=60):
    """POST to the stream route and parse its SSE frames with the port's
    ``iter_sse``; with ``limit``, stop (and drop the connection) after
    that many token frames."""
    from fengshen_tpu_torch.streaming import iter_sse
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/text_generation/stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    frames = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for frame in iter_sse(r):
            frames.append(frame)
            if limit is not None and len(frames) == limit:
                break
    return frames


def _stream_tokens(frames):
    toks = [f for f in frames if f["event"] == "token"]
    assert [f["id"] for f in toks] == list(range(toks[0]["id"],
                                                 toks[0]["id"] + len(toks)))
    return [f["data"]["token"] for f in toks]


def test_stream_route_equals_blocking_and_reconnects_gaplessly(
        port_model, port_refs):
    """Four concurrent streams give the blocking route's tokens (each
    ``token`` event's id is its index, then one ``done`` event with the
    result); a client that drops after three tokens reconnects with
    ``Last-Event-ID: 2`` (and again with a body ``last_event_id``) and
    gets the rest with no gap; an unknown id answers 404."""
    from concurrent.futures import ThreadPoolExecutor
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cpu")
    engine = start_continuous_engine(pipe, _surface_config("paged"))
    served = _Served(build_stdlib_server, _local(), pipe, engine)
    try:
        texts = [" ".join(map(str, p)) for p in _prompts()]
        with ThreadPoolExecutor(4) as pool:
            streams = list(pool.map(
                lambda t: _stream(served.port, {"input_text": t}), texts))
        for frames, ref in zip(streams, port_refs):
            assert _stream_tokens(frames) == ref
            assert frames[-1]["event"] == "done"
            assert frames[-1]["id"] == len(ref)
            assert frames[-1]["data"]["result"] == " ".join(map(str, ref))
        blocking = [_post(served.port, {"input_text": t})["result"]
                    for t in texts]
        assert blocking == [" ".join(map(str, r)) for r in port_refs]
        head = _stream(served.port, {"input_text": texts[0],
                                     "request_id": "rc"}, limit=3)
        tail = _stream(served.port, {"request_id": "rc"},
                       headers={"Last-Event-ID": "2"})
        assert _stream_tokens(head) + _stream_tokens(tail) == port_refs[0]
        again = _stream(served.port, {"request_id": "rc",
                                      "last_event_id": 6})
        assert _stream_tokens(again) == port_refs[0][7:]
        assert _post_status(served.port, "/api/text_generation/stream",
                            {"request_id": "nope", "last_event_id": 0}
                            )[0] == 404
        stats = engine.stats()
        assert stats["streams_active"] == 0
        text = _render_text(engine)
        assert "fstpu_stream_reconnects_total 2" in text
        assert f"fstpu_stream_tokens_total {4 * MAX_NEW + MAX_NEW}" in text
    finally:
        served.close()


def _render_text(engine):
    from fengshen_tpu_torch.observability import render_prometheus
    return render_prometheus(engine.metrics.registry)


def _families(text):
    """{family: sorted label names} from ``# TYPE`` lines and samples."""
    fams, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            fams[line.split()[2]] = set()
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split()[0]
            base = next((f for f in fams if name in
                         (f, f + "_bucket", f + "_sum", f + "_count")), None)
            if "{" in line:
                keys = {kv.split("=")[0] for kv in
                        line[line.index("{") + 1:line.index("}")].split(
                            ",")} - {"le"}
                labels.setdefault(base, set()).update(keys)
    return {f: sorted(labels.get(f, ())) for f in fams}


def _samples(text):
    """{sample name with labels: value} of a Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _http_sequence(port, texts):
    """The same request sequence for either package's server: a
    blocking POST, a traced one, a stream, a 413, a 422, and the read
    routes."""
    trace = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    out = [_post_status(port, "/api/text_generation",
                        {"input_text": texts[0]})]
    out.append(_post_status(port, "/api/text_generation",
                            {"input_text": texts[1], "request_id": "t1"},
                            headers={"traceparent": trace}))
    out.append(_stream_tokens(_stream(port, {"input_text": texts[2],
                                             "request_id": "s2"})))
    out.append(_post_status(port, "/api/text_generation",
                            {"input_text": " ".join(["3"] * 17)})[0])
    out.append(_post_status(port, "/api/text_generation",
                            {"input_text": "5", "max_new_tokens": 0})[0])
    out.append(_get(port, "/partial/t1"))
    out.append(_get(port, "/debug/requests/t1"))
    out.append(_get(port, "/debug/requests"))
    out.append(_get(port, "/stats"))
    out.append(_get(port, "/healthz"))
    return out


def test_http_surface_matches_jax_server(jax_side, port_model, port_refs):
    """The port's server and the JAX package's stdlib server, the same
    weights, engine settings and request sequence: the same bodies
    (results, ``trace_id`` echoed, 413/422, ``/partial``, the debug
    payloads' keys and event names, ``/stats`` keys, ``/healthz``);
    ``/metrics`` has the JAX server's engine families with the same
    label names and values, and the same HTTP counts by route and code."""
    from fengshen_tpu.api.main import ServerConfig as JaxServerConfig
    from fengshen_tpu.api.main import build_stdlib_server as jax_build
    from fengshen_tpu.api.main import \
        start_continuous_engine as jax_start
    from fengshen_tpu.pipelines.text_generation import \
        Pipeline as JaxPipeline
    texts = [" ".join(map(str, p)) for p in _prompts()]
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cpu")
    jpipe = JaxPipeline(module=JaxLlama(JaxLlamaConfig(**CFG)),
                        params=jax_side[0], tokenizer=IdTokenizer(),
                        max_new_tokens=MAX_NEW)
    from fengshen_tpu.observability import \
        render_prometheus as jax_render
    from fengshen_tpu_torch.observability import render_prometheus
    runs = {}
    for name, build, start, p, cfg, render in (
            ("port", build_stdlib_server, start_continuous_engine, pipe,
             _local(engine="continuous"), render_prometheus),
            ("jax", jax_build, jax_start, jpipe,
             JaxServerConfig(host="127.0.0.1", port=0,
                             engine="continuous"), jax_render)):
        engine = start(p, _surface_config("slot"))
        served = _Served(build, cfg, p, engine)
        try:
            before = _samples(_get(served.port, "/metrics")[1])
            seq = _http_sequence(served.port, texts)
            after = _get(served.port, "/metrics")[1]
        finally:
            served.close()
        runs[name] = (seq, before, after,
                      render(engine.metrics.registry))
    (mine, m_before, m_after, m_engine), (ref, r_before, r_after,
                                          r_engine) = \
        runs["port"], runs["jax"]
    for (mc, mb), (rc, rb) in zip(mine[:2], ref[:2]):
        # the port's body adds generated_tokens; ttft_s is measured and
        # an id the server makes counts per process
        assert mc == rc == 200
        assert mb.keys() == rb.keys() | {"generated_tokens"}
        for key in rb.keys() - {"ttft_s", "request_id"}:
            assert mb[key] == rb[key], key
    assert mine[0][1]["result"] == " ".join(map(str, port_refs[0]))
    assert mine[1][1]["trace_id"] == ref[1][1]["trace_id"] == "ab" * 16
    assert mine[1][1]["request_id"] == ref[1][1]["request_id"] == "t1"
    assert mine[2] == ref[2] == port_refs[2]
    assert mine[3:5] == ref[3:5] == [413, 422]
    (mc, mp), (rc, rp) = mine[5], ref[5]
    assert (mc, mp.keys()) == (rc, rp.keys())
    assert {k: v for k, v in mp.items() if k != "ttft_s"} == \
        {k: v for k, v in rp.items() if k != "ttft_s"}
    (mc, md), (rc, rd) = mine[6], ref[6]
    assert mc == rc == 200 and md.keys() == rd.keys()
    assert _event_names(md) == _event_names(rd)
    assert md["trace_id"] == rd["trace_id"] == "ab" * 16
    assert mine[7][1].keys() == ref[7][1].keys()
    assert set(ref[8][1]) <= set(mine[8][1])
    assert mine[9] == ref[9] == (200, {"status": "ok",
                                       "task": "text_generation",
                                       "ready": True})
    assert _families(m_engine) == _families(r_engine)
    engine_counters = {k: v for k, v in _samples(r_engine).items()
                       if "seconds" not in k and "fragmentation" not in k
                       and "uptime" not in k}
    mine_counters = _samples(m_engine)
    for key, value in engine_counters.items():
        assert mine_counters[key] == value, key

    def http_delta(before, after):
        now = _samples(after)
        return {k: v - before.get(k, 0) for k, v in now.items()
                if k.startswith("fstpu_http_requests_total")
                and v != before.get(k, 0)}
    assert http_delta(m_before, m_after) == http_delta(r_before, r_after)
    fams = _families(m_after)
    for fam, labels in _families(r_after).items():
        if fam.startswith(("fstpu_http", "fstpu_span", "fstpu_serving",
                           "fstpu_request", "fstpu_kv", "fstpu_stream")):
            assert fams.get(fam) == labels, fam
    spans = {k for k, v in _samples(m_after).items()
             if k.startswith("fstpu_span_seconds_count")}
    for name in ("serving/admit", "serving/prefill", "serving/decode"):
        assert f'fstpu_span_seconds_count{{span="{name}"}}' in spans


def test_duplicate_id_dump_and_debug_routes(tmp_path, port_model,
                                            port_refs):
    """A POST whose ``request_id`` is live answers 409; ``POST
    /debug/dump`` writes a bundle into the recorder's ``dump_dir`` (the
    engine's stats, config and timelines); ``/debug/requests`` lists the
    queued request, and ``/partial/<id>`` equals the engine's journal
    entry plus its decoded result once it finished."""
    from fengshen_tpu_torch.api.main import create_continuous_engine
    from fengshen_tpu_torch.observability import FlightRecorder
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cpu")
    recorder = FlightRecorder(dump_dir=str(tmp_path / "dumps"))
    engine = create_continuous_engine(pipe, _surface_config("slot"),
                                      recorder=recorder)
    engine.warmup()
    served = _Served(build_stdlib_server, _local(dump_dir=str(
        tmp_path / "dumps")), pipe, engine, recorder=recorder)
    try:
        # the engine is not ticking yet: the request stays queued
        req = engine.submit(_prompts()[0], request_id="dup")
        code, body = _post_status(served.port, "/api/text_generation",
                                  {"input_text": "5 6", "request_id": "dup"})
        assert code == 409 and "dup" in body["error"]
        code, body = _get(served.port, "/debug/requests")
        assert [r["request_id"] for r in body["in_flight"]] == ["dup"]
        code, body = _post_status(served.port, "/debug/dump", {})
        assert code == 200
        bundle = Path(body["bundle"])
        assert bundle.parent == tmp_path / "dumps"
        manifest = json.loads((bundle / "manifest.json").read_text())
        assert manifest["reason"] == "on_demand"
        assert manifest["files"] == ["engine.json", "events.jsonl"]
        dumped = json.loads((bundle / "engine.json").read_text())
        assert dumped["stats"]["rejected_duplicate"] == 1
        assert [r["request_id"] for r in dumped["requests"]] == ["dup"]
        engine.start()
        assert req.wait(timeout=60)
        code, body = _get(served.port, "/partial/dup")
        assert code == 200
        assert body == dict(engine.partial("dup"), result=" ".join(
            map(str, port_refs[0])))
        code, body = _get(served.port, "/debug/requests/dup")
        assert code == 200 and _event_names(body)[-1] == "finished"
        assert _get(served.port, "/debug/requests/none")[0] == 404
        assert _get(served.port, "/partial/none")[0] == 404
    finally:
        served.close()


def test_simple_engine_serves_generate_tokens(checkpoint_dir):
    """``engine: "simple"``: one pipeline call per POST behind a lock,
    giving the JAX pipeline's text (``generate``'s greedy tokens) for
    its prompt; ``/stats`` is the reference's simple payload, the stream
    route answers 501 and ``/partial`` 404, and ``/metrics`` counts the
    pipeline's tokens."""
    from fengshen_tpu.pipelines.text_generation import \
        Pipeline as JaxPipeline
    from fengshen_tpu_torch.api.main import SimpleEngine
    pipe = Pipeline(model=str(checkpoint_dir), max_new_tokens=6,
                    device="cpu")
    ref = JaxPipeline(model=str(checkpoint_dir), max_new_tokens=6)
    engine = SimpleEngine(pipe)
    assert engine.warmup() > 0
    served = _Served(build_stdlib_server, _local(engine="simple"), pipe,
                     engine)
    try:
        for text in TEXTS[:2]:
            code, body = _post_status(served.port, "/api/text_generation",
                                      {"input_text": text})
            assert (code, body) == (200, {"result": ref(text)})
        code, body = _post_status(served.port, "/api/text_generation",
                                  {"input_text": TEXTS[0],
                                   "max_new_tokens": 2})
        assert body == {"result": ref(TEXTS[0], max_new_tokens=2)}
        assert _get(served.port, "/stats") == (200, {
            "engine": "simple", "task": "text_generation", "phase": "both"})
        assert _post_status(served.port, "/api/text_generation/stream",
                            {"input_text": TEXTS[0]})[0] == 501
        assert _get(served.port, "/partial/x")[0] == 404
        assert _get(served.port, "/debug/requests")[1] == {
            "in_flight": [], "recent": [], "debug_ring": 0}
        metrics = _get(served.port, "/metrics")[1]
        assert "fstpu_pipeline_generated_tokens_total" in metrics
        assert 'fstpu_span_seconds_count{span="pipeline/generate"}' in \
            metrics
    finally:
        served.close()


@pytest.mark.parametrize("kind", ["continuous", "simple"])
def test_failed_warmup_never_becomes_ready(port_model, monkeypatch, kind):
    """A kernel that fails in warmup stops the engine with the reason:
    ``/healthz`` answers 503 ``engine_stopped`` with the error (never
    ready, unlike the reference's serve-anyway warmup), and a generate
    request answers 503."""
    from fengshen_tpu_torch.api.main import (SimpleEngine,
                                             _start_warmup_thread,
                                             create_continuous_engine)
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.ops.kernels import KernelError
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=4, device="cpu")
    engine = SimpleEngine(pipe) if kind == "simple" else \
        create_continuous_engine(pipe, {"num_slots": 2, "buckets": (8,)})

    def broken(*args, **kwargs):
        raise KernelError("injected build failure")

    monkeypatch.setattr(modeling_llama, "decode_attention", broken)
    cfg = _local(engine=kind)
    ready = _start_warmup_thread(cfg, PipelineConfig(), pipe, engine)
    served = _Served(build_stdlib_server, cfg, pipe, engine, ready=ready)
    try:
        import time
        deadline = time.monotonic() + 60
        while engine.stopped_reason() is None:
            assert time.monotonic() < deadline, "warmup never ended"
            time.sleep(0.05)
        code, body = _get(served.port, "/healthz")
        assert code == 503 and body["ready"] is False
        assert body["reason"] == "engine_stopped"
        assert "a failed warmup" in body["error"]
        assert "injected build failure" in body["error"]
        assert not ready.is_set()
        code, body = _post_status(served.port, "/api/text_generation",
                                  {"input_text": "5 6 7"})
        assert code == 503 and body["reason"] == "engine_stopped"
    finally:
        served.close()


def test_drain_finishes_in_flight_and_refuses_new_work(tmp_path, port_model,
                                                       port_refs):
    """The SIGTERM drain's body, called directly: the running request
    finishes with its tokens, the queued one is flushed with 503
    "draining", a new POST answers 503 "draining", ``/healthz`` answers
    the reference's draining payload, and once idle the drain dumps a
    bundle and shuts the server down. ``install_drain_handler`` installs
    it on SIGTERM and hands back the previous handler, restored here."""
    from concurrent.futures import ThreadPoolExecutor

    from fengshen_tpu.api.main import _healthz_payload as jax_healthz
    from fengshen_tpu_torch.api.main import (_healthz_payload,
                                             create_continuous_engine,
                                             drain, install_drain_handler)
    from fengshen_tpu_torch.observability import FlightRecorder
    pipe = Pipeline(module=port_model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cpu")
    engine = create_continuous_engine(pipe, {"num_slots": 1,
                                             "buckets": (8, 16)})
    engine.warmup()
    recorder = FlightRecorder(dump_dir=str(tmp_path / "dumps"))
    draining = threading.Event()
    served = _Served(build_stdlib_server, _local(), pipe, engine,
                     recorder=recorder, draining=draining)
    texts = [" ".join(map(str, p)) for p in _prompts()[:2]]
    pool = ThreadPoolExecutor(2)
    try:
        previous = install_drain_handler(served.server, draining,
                                         engine=engine)
        try:
            assert signal.getsignal(signal.SIGTERM) is not previous
        finally:
            signal.signal(signal.SIGTERM, previous)
        import time
        running = pool.submit(_post_status, served.port,
                              "/api/text_generation",
                              {"input_text": texts[0]})
        while engine.stats()["queue_depth"] < 1:
            time.sleep(0.01)
        engine.step()                       # admits it into the one lane
        queued = pool.submit(_post_status, served.port,
                             "/api/text_generation",
                             {"input_text": texts[1]})
        while engine.stats()["queue_depth"] < 1:
            time.sleep(0.01)
        waiter = drain(served.server, draining, engine=engine,
                       recorder=recorder, poll_s=0.01)
        assert queued.result(timeout=30) == (503, {
            "error": "request rejected (draining)", "reason": "draining"})
        assert _post_status(served.port, "/api/text_generation",
                            {"input_text": texts[1]}) == (503, {
                                "error": "replica draining",
                                "reason": "draining"})
        code, body = _get(served.port, "/healthz")
        assert (code, body) == _healthz_payload(
            "text_generation", None, draining) == jax_healthz(
            "text_generation", None, draining)
        assert drain(served.server, draining, engine=engine) is None
        engine.start()
        code, body = running.result(timeout=60)
        assert code == 200
        assert body["result"] == " ".join(map(str, port_refs[0]))
        waiter.join(timeout=30)
        assert not waiter.is_alive()
        served.thread.join(timeout=10)
        assert not served.thread.is_alive()
        bundles = [p.name for p in (tmp_path / "dumps").iterdir()]
        assert bundles == ["dump-0000-sigterm_drain"]
    finally:
        pool.shutdown()
        served.close()


def test_healthz_payloads_are_the_references():
    """Warmup, draining and ready payloads byte for byte."""
    from fengshen_tpu.api.main import _healthz_payload as jax_healthz
    from fengshen_tpu_torch.api.main import _healthz_payload
    ready, draining = threading.Event(), threading.Event()
    for step in range(3):
        for args in ((ready, draining), (None, None), (ready, None),
                     (None, draining)):
            got = _healthz_payload("text_generation", *args)
            want = jax_healthz("text_generation", *args)
            assert json.dumps(got) == json.dumps(want)
        (ready if step == 0 else draining).set()
