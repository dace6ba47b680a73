"""Sampled and speculative serving on the card (``gpu``-marked; skipped
without one). This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_serving_gpu.py

- The counter-based draws give the same bits on the card as on the CPU,
  and a sampled lane's tokens do not depend on its co-tenants there.
- K3 counts its launches per query-window length (``"s1"``, ``"s5"``),
  and a speculative engine launches it exactly once per layer per verify
  window (plus once per draft layer per draft step under ``self_draft``).
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
