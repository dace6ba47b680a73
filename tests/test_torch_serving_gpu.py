"""Sampled and speculative serving on the card (``gpu``-marked; skipped
without one). This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_serving_gpu.py

- The counter-based draws give the same bits on the card as on the CPU,
  and a sampled lane's tokens do not depend on its co-tenants there.
- K3 counts its launches per query-window length (``"s1"``, ``"s5"``),
  and a speculative engine launches it exactly once per layer per verify
  window (plus once per draft layer per draft step under ``self_draft``).
- A checkpoint directory loads straight onto the card, every parameter
  bitwise equal to the tensor written; the stream route through K3
  gives the blocking route's tokens, and K3's launches are pinned under
  streaming and under the ``simple`` engine.
- A greedy speculative engine through K3 serves the tokens of the same
  engine with K3's plain version swapped in. They may part only at a
  near-tie: at a sequence's first disagreement the plain-served
  sequence's top-2 gap (a cacheless forward) is within ``MARGIN`` of the
  pool dtype: 1e-3 in fp32 (K3 is held to 1e-4 of its plain version),
  0.25 logits in bf16 (2e-2 per attention element, through two layers
  and the LM head).
"""

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                             modeling_llama)
from fengshen_tpu_torch.ops.kernels import get_entry, reset_launch_counts
from fengshen_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, torch_decode_attention)
from fengshen_tpu_torch.serving import (BucketLadder,
                                        ContinuousBatchingEngine,
                                        EngineConfig)
from fengshen_tpu_torch.utils.rng import Draws, categorical

#: head_dim 64 (the kernel's rules), GQA 2:1, two layers
CARD_CFG = dict(vocab_size=97, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, max_position_embeddings=128,
                initializer_range=0.2, attention_impl="dense")
MARGIN = {"float32": 1e-3, "bfloat16": 0.25}
SPEC = {"prompt_lookup": dict(spec_mode="prompt_lookup", spec_gamma=4),
        "self_draft": dict(spec_mode="self_draft", spec_gamma=4,
                           spec_draft_layers=1)}
MAX_NEW = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dtype, device):
    cfg = LlamaConfig(**CARD_CFG, dtype=dtype, param_dtype=dtype)
    return LlamaForCausalLM(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    rand = [rng.randint(3, 96, n).astype(np.int32) for n in (5, 11, 16, 7)]
    loops = [np.resize(rng.randint(3, 96, 3), 14).astype(np.int32)
             for _ in range(2)]
    return rand + loops


@pytest.mark.gpu
def test_cuda_draws_equal_cpu_draws(cuda_device):
    """The hash is integer arithmetic: the card and the CPU draw the same
    bits, uniforms and (away from ties) categorical tokens."""
    cpu = Draws.for_rows(7, 16, counter=3).sub(5)
    card = Draws(cpu.keys.to(cuda_device), cpu.counter.to(cuda_device),
                 cpu.stream)
    assert torch.equal(card.bits(4096).cpu(), cpu.bits(4096))
    assert torch.equal(card.uniform(4096).cpu(), cpu.uniform(4096))
    logits = torch.randn(16, 4096, generator=torch.Generator().manual_seed(1))
    assert torch.equal(categorical(card, logits.to(cuda_device)).cpu(),
                       categorical(cpu, logits))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "self_draft"])
def test_cuda_sampled_lane_is_pure(cuda_device, mode):
    """On the card too, a request draws the same tokens whatever its slot,
    admission order and co-tenants."""
    model = _model("float32", cuda_device)
    prompts = _prompts()
    kw = dict(buckets=(8, 16), max_new_tokens=MAX_NEW, max_queue=16, seed=2,
              do_sample=True, temperature=0.8, top_k=6,
              **(SPEC[mode] if mode != "off" else {}))
    crowd = ContinuousBatchingEngine(model, EngineConfig(num_slots=3, **kw))
    a = [crowd.submit(p, request_id=f"r{i}") for i, p in enumerate(prompts)]
    crowd.run_until_idle()
    alone = ContinuousBatchingEngine(model, EngineConfig(num_slots=1, **kw))
    b = [alone.submit(p, request_id=f"r{i}")
         for i, p in reversed(list(enumerate(prompts)))]
    alone.run_until_idle()
    assert [r.tokens for r in a] == [r.tokens for r in reversed(b)]


@pytest.mark.gpu
def test_k3_counts_launches_per_window(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    entry = get_entry("decode_attention")
    reset_launch_counts()
    k = torch.randn(2, 64, 1, 64, device=cuda_device, generator=gen)
    for s in (1, 5, 5):
        q = torch.randn(2, s, 2, 64, device=cuda_device, generator=gen)
        valid = torch.ones(2, s, 64, dtype=torch.bool, device=cuda_device)
        decode_attention(q, k, k, valid)
    torch.cuda.synchronize()
    assert entry.variants == {"s1": 1, "s5": 2} and entry.launches == 3
    assert entry.dense_calls == 0


def _serve(model, mode, layout, plain=False):
    # one bucket of 16: every prefill takes the dense route (a window of
    # 8 or fewer would be a K3 launch of its own)
    kw = dict(num_slots=3, buckets=(16,), max_new_tokens=MAX_NEW,
              max_queue=16, kv_layout=layout, kv_block_size=16, **SPEC[mode])
    eng = ContinuousBatchingEngine(model, EngineConfig(**kw))
    eng.warmup()
    reset_launch_counts()
    if plain:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(modeling_llama, "decode_attention",
                       torch_decode_attention)
            served = eng.generate_all(_prompts())
    else:
        served = eng.generate_all(_prompts())
    return served, eng.stats()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(SPEC))
def test_spec_engine_launches_k3_per_variant(cuda_device, mode):
    model = _model("bfloat16", cuda_device)
    _, stats = _serve(model, mode, "paged")
    entry = get_entry("decode_attention")
    ticks = stats["decode_ticks"]
    want = {"s5": 2 * ticks}
    if mode == "self_draft":
        want["s1"] = 1 * 5 * ticks
    assert ticks > 0 and entry.variants == want
    assert entry.launches == sum(want.values())
    # the prefills (windows of 16) take the dense route, nothing else
    assert entry.dense_calls == 2 * stats["completed"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("mode", list(SPEC))
def test_spec_engine_through_k3_equals_plain(cuda_device, mode, layout,
                                             dtype):
    model = _model(dtype, cuda_device)
    got, _ = _serve(model, mode, layout)
    want, _ = _serve(model, mode, layout, plain=True)
    ladder = BucketLadder((16,))
    for prompt, a, b in zip(_prompts(), want, got):
        assert len(a) == len(b) == MAX_NEW
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        bucket = ladder.bucket_for(len(prompt))
        row, mask = ladder.pad_prompt(prompt, bucket)
        ids = torch.tensor(list(row) + a[:-1], device=cuda_device)[None]
        m = torch.tensor(list(mask) + [1] * (len(a) - 1),
                         device=cuda_device)[None]
        with torch.no_grad():
            logits = model(ids, attention_mask=m,
                           position_ids=(m.cumsum(-1) - 1).clamp(min=0))
        top2 = logits[0, bucket - 1 + t].float().topk(2).values
        assert float(top2[0] - top2[1]) <= MARGIN[dtype], (prompt, t)


def _write_safetensors(path, tensors):
    """A safetensors file from a dict of CPU tensors (the format: an
    8-byte little-endian header length, the JSON header, the bytes)."""
    import json
    import struct
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_loads_onto_the_card_bitwise(cuda_device, tmp_path,
                                                dtype):
    """Two safetensors shards (and a ``.bin`` beside them, which the
    safetensors win over) load onto the card: every parameter equals the
    tensor written, bit for bit, in the config's ``param_dtype``."""
    from fengshen_tpu_torch.models.llama import load_hf_pretrained
    model = _model(dtype, cuda_device)
    model.config.save_pretrained(str(tmp_path))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    keys = sorted(state)
    for i in range(2):
        _write_safetensors(tmp_path / f"model-{i}.safetensors",
                           {k: state[k] for k in keys[i::2]})
    torch.save({k: v + 1 for k, v in state.items()},
               tmp_path / "pytorch_model.bin")
    _, loaded = load_hf_pretrained(str(tmp_path), device="cuda")
    got = loaded.state_dict()
    assert got.keys() == state.keys()
    for name, tensor in state.items():
        assert got[name].device.type == "cuda"
        assert torch.equal(got[name].cpu(), tensor), name


def _http(port, path, payload=None, headers=None):
    import json
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


@pytest.mark.gpu
def test_stream_route_through_k3_equals_blocking(cuda_device):
    """Over HTTP on the card: each streamed sequence equals the blocking
    route's for its prompt, a reconnect after three tokens continues
    without a gap, and K3 launches exactly once per layer per decode
    tick (prefills of 16 take the dense route)."""
    import json
    import threading

    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             build_stdlib_server,
                                             start_continuous_engine)
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    from fengshen_tpu_torch.streaming import iter_sse
    model = _model("bfloat16", cuda_device)
    pipe = Pipeline(module=model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cuda")
    engine = start_continuous_engine(pipe, {
        "num_slots": 3, "buckets": (16,), "kv_layout": "paged",
        "kv_block_size": 16})
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, engine="continuous"),
        PipelineConfig(), pipeline=pipe, engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    entry = get_entry("decode_attention")
    try:
        texts = [" ".join(map(str, p)) for p in _prompts()]

        def stream(payload, headers=None, limit=None):
            frames = []
            with _http(port, "/api/text_generation/stream", payload,
                       headers) as r:
                for f in iter_sse(r):
                    frames.append(f)
                    if limit is not None and len(frames) == limit:
                        break
            return [f["data"]["token"] for f in frames
                    if f["event"] == "token"], frames

        reset_launch_counts()
        before = engine.stats()["decode_ticks"]
        streamed = [stream({"input_text": t, "request_id": f"g{i}"})[0]
                    for i, t in enumerate(texts)]
        ticks = engine.stats()["decode_ticks"] - before
        assert entry.variants == {"s1": 2 * ticks}
        blocking = []
        for t in texts:
            with _http(port, "/api/text_generation", {"input_text": t}) as r:
                blocking.append([int(x) for x in
                                 json.loads(r.read())["result"].split()])
        assert streamed == blocking
        head, _ = stream({"input_text": texts[0], "request_id": "rc"},
                         limit=3)
        tail, frames = stream({"request_id": "rc"},
                              headers={"Last-Event-ID": "2"})
        assert head + tail == blocking[0]
        assert frames[0]["id"] == 3 and frames[-1]["event"] == "done"
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)


@pytest.mark.gpu
def test_simple_engine_launches_k3_per_decode_step(cuda_device):
    """The ``simple`` engine's one-request path decodes through K3: one
    launch per layer per decode step (a prompt of 11 prefills on the
    dense route), with the continuous engine's greedy tokens in fp32."""
    from fengshen_tpu_torch.api.main import SimpleEngine
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    model = _model("float32", cuda_device)
    pipe = Pipeline(module=model, tokenizer=IdTokenizer(),
                    max_new_tokens=MAX_NEW, device="cuda")
    simple = SimpleEngine(pipe)
    simple.warmup()
    prompt = _prompts()[1]
    reset_launch_counts()
    text = simple.generate(" ".join(map(str, prompt)))
    entry = get_entry("decode_attention")
    assert entry.variants == {"s1": 2 * (MAX_NEW - 1)}
    assert entry.dense_calls == 2
    eng = ContinuousBatchingEngine(model, EngineConfig(
        num_slots=2, buckets=(16,), max_new_tokens=MAX_NEW))
    (tokens,) = eng.generate_all([prompt])
    assert [int(t) for t in text.split()] == tokens
