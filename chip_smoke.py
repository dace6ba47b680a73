#!/usr/bin/env python3
"""Drive the PyTorch port (``fengshen_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each raises on failure, so any failure exits non-zero):

1. device: torch, CUDA and the card's name and power limit;
2. build: the kernel library from ``fengshen_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it, with its time, the plain version's, one
   PyTorch library call's (``library_ms``, a yardstick the port never
   calls) and the bound (the least time the card could take);
4. main path: Ziya-LLaMA-13B at full width and depth (bf16 weights made
   on the card from a seed) served through the stdlib HTTP server and
   the continuous-batching engine, first over a paged KV pool, then over
   a slot pool; every kernel's launch count is set to 0 just before each
   run and read just after;
5. teacher-forced check: every served sequence re-scored by one
   cacheless forward of the same model;
6. profile: a few decode ticks under ``torch.profiler`` (device busy
   and idle share per tick, the kernels that take the time).

It prints one line per phase, then a ``{"kernels": [...]}`` JSON line,
then as its last line ``{"ok": true, "device": {...}}``. Without a card,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ZIYA_CONFIG = ROOT / "workspace" / "ziya-llama-13b" / "config.json"

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and fp32
#: FLOP/s outside the tensor cores (the decode kernel's arithmetic)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: bf16 kernel vs plain version: the plain version rounds the softmax
#: probabilities to bf16 before the PV product (as the JAX dense path
#: does) and both round the output to bf16 (ulp 2^-8 near 1), so the two
#: may differ by a few 1e-3; 2e-2 leaves room without hiding a wrong sum
KERNEL_ATOL = 2e-2
#: teacher-forced re-scoring margin in logits, see phase 5
TF_MARGIN = 0.5

NEW_TOKENS = 32
PROMPT_LENGTHS = (5, 40, 64, 65, 100, 130, 200, 300)   # buckets 64..512


def say(phase: str, **fields) -> None:
    print(f"[{phase}] {json.dumps(fields, default=str)}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the device (CUDA events), after
    two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 ------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
        capability=torch.cuda.get_device_capability(0),
        count=torch.cuda.device_count(), nvidia_smi=card)
    return card


# -- phase 2 ------------------------------------------------------------

def phase_build():
    from fengshen_tpu_torch.ops.kernels import build, probe
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in build.last_build_log.splitlines()
             if "registers" in line or "spill" in line]
    say("build", seconds=round(seconds, 3), library=build.library_path().name,
        ptxas=ptxas, probe=probe().describe())
    return seconds


# -- phase 3 ------------------------------------------------------------

def decode_case(layout: str, s: int, gen):
    """Operands at the main path's shapes: 8 lanes, 40 heads (MHA), head
    dim 128, bf16, lanes of 2048 positions (paged: 32 blocks of 64 behind
    a shuffled table). Lanes are filled to different lengths, some with
    left padding; lane 7 is parked (fully masked, on the null block)."""
    import torch
    B, H, KVH, D, L, BS = 8, 40, 40, 128, 2048, 64
    fill = [2048, 1024, 1500, 700, 64, 300, 1900, 0]
    pad = [0, 5, 0, 30, 0, 12, 0, 0]
    dev = "cuda"
    q = torch.randn(B, s, H, D, generator=gen, device=dev).bfloat16()
    pos = torch.arange(L, device=dev)
    valid = torch.zeros(B, s, L, dtype=torch.bool, device=dev)
    for b in range(B):
        for t in range(s):
            valid[b, t] = (pos <= fill[b] - s + t) & (pos >= pad[b]) \
                if fill[b] else False
    table = None
    if layout == "paged":
        nb = B * (L // BS) + 1
        shape = (nb, BS, KVH, D)
        table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1
                 ).view(B, L // BS).int()
        table[7] = 0
    else:
        shape = (B, L, KVH, D)
    k = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    return q, k, v, valid, table


def decode_bound(q, k, valid, table):
    """Least time for one call: the bytes it must move over HBM rate,
    against fp32 flops over the CUDA-core rate; the larger bounds it.
    Counted: q read and out written once, the valid mask and table read
    once, and per lane the K and V rows of every position some query row
    may attend to (a parked lane's output is the mean of ALL its values,
    so its V rows, not its K rows, count)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    L = valid.shape[2]
    row_bytes = KVH * D * k.element_size()
    attended = valid.any(1).sum(1).tolist()               # per lane
    kv = sum(2 * n * row_bytes if n else L * row_bytes for n in attended)
    moved = (2 * q.numel() * q.element_size() + valid.numel() + kv +
             (0 if table is None else table.numel() * 4))
    flops = sum(4 * S * H * D * (n or L) for n in attended)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations", moved


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels.decode_attention import (
        cuda_decode_attention, torch_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for layout in ("slot", "paged"):
        for s in (1, 5):
            q, k, v, valid, table = decode_case(layout, s, gen)
            out = cuda_decode_attention(q, k, v, valid, block_table=table)
            torch.cuda.synchronize()
            ref = torch_decode_attention(q, k, v, valid, block_table=table)
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"{layout} S={s}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            parked_err = (out[7].float() - ref[7].float()).abs().max().item()
            if err > KERNEL_ATOL:
                raise AssertionError(f"{layout} S={s}: max abs err {err} "
                                     f"> {KERNEL_ATOL}")
            ms = cuda_ms(lambda: cuda_decode_attention(
                q, k, v, valid, block_table=table), 50)
            plain_ms = cuda_ms(lambda: torch_decode_attention(
                q, k, v, valid, block_table=table), 5)
            # yardstick: SDPA over the pre-gathered lanes, same mask
            if table is None:
                kg, vg = k, v
            else:
                idx = (table.long()[:, :, None] * k.shape[1] +
                       torch.arange(k.shape[1], device="cuda")).flatten(1)
                kg = k.flatten(0, 1)[idx]
                vg = v.flatten(0, 1)[idx]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, kg, vg))
            mask = valid[:, None]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 20)
            bound_ms, bound_by, moved = decode_bound(q, k, valid, table)
            rows[(layout, s)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            say("kernel", name="decode_attention", layout=layout, S=s,
                shape=list(q.shape), pool=list(k.shape), max_abs_err=err,
                parked_lane_err=parked_err, tolerance=KERNEL_ATOL,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes_moved=moved,
                fraction_of_bound=bound_ms / ms)
            del q, k, v, valid, table, out, ref, kg, vg, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


# -- phase 4 ------------------------------------------------------------

def post(port: int, text: str) -> tuple:
    body = json.dumps({"input_text": text,
                       "max_new_tokens": NEW_TOKENS}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/text_generation", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t0


def serve_run(pipe, layout: str, prompts, entry):
    """One engine + server on port 0; 8 concurrent POSTs. Returns the
    served token ids per prompt and the launch count of the run."""
    import torch
    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             build_stdlib_server,
                                             start_continuous_engine)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    engine = start_continuous_engine(
        pipe, {"num_slots": 8, "kv_layout": layout, "max_queue": 16})
    server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0),
        PipelineConfig(task="text_generation"), pipeline=pipe,
        engine=engine)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        before = engine.stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            results = list(pool.map(
                lambda p: post(port, " ".join(map(str, p))), prompts))
        wall = time.perf_counter() - t0
        launches, dense_calls = entry.launches, entry.dense_calls
        after = engine.stats()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    ticks = after["decode_ticks"] - before["decode_ticks"]
    prefills = sum(after["prefills_per_bucket"].values()) - \
        sum(before["prefills_per_bucket"].values())
    served = []
    for (status, body, _), prompt in zip(results, prompts):
        if status != 200 or body["generated_tokens"] != NEW_TOKENS:
            raise AssertionError(f"{layout}: {status} {body}")
        served.append([int(t) for t in body["result"].split()])
    layers = pipe.module.config.num_hidden_layers
    if ticks < NEW_TOKENS - 1 or launches != layers * ticks:
        raise AssertionError(
            f"{layout}: {launches} decode-kernel launches over {ticks} "
            f"decode ticks; every layer of every tick must launch it "
            f"({layers} x ticks)")
    if dense_calls != layers * prefills:
        raise AssertionError(f"{layout}: {dense_calls} dense-route calls "
                             f"for {prefills} prefills")
    tokens = NEW_TOKENS * len(prompts)
    say("serve", layout=layout, requests=len(prompts),
        prompt_tokens=[len(p) for p in prompts],
        buckets=sorted(after["prefills_per_bucket"]),
        generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        decode_ticks=ticks, decode_tokens_per_s_engine=(
            (after["decode_tokens"] - before["decode_tokens"]) /
            (after["decode_seconds"] - before["decode_seconds"])),
        latency_s=[round(r[2], 4) for r in results],
        ttft_s=[round(r[1]["ttft_s"], 4) for r in results],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        kv_cache_gib=after["kv_cache_bytes"] / 2**30,
        decode_attention_launches=launches,
        dense_route_calls=dense_calls, prefills=prefills)
    del engine, server, thread
    gc.collect()
    torch.cuda.empty_cache()
    return served, launches


def phase_main_path():
    import torch
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    import numpy as np

    # the cacheless forward (phase 5) is dense: kernel K1 (flash) is not
    # ported, and the serving path never takes that branch
    cfg = dataclasses.replace(LlamaConfig.from_pretrained(str(ZIYA_CONFIG)),
                              param_dtype="bfloat16", dtype="bfloat16",
                              attention_impl="dense")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("model", config=str(ZIYA_CONFIG.relative_to(ROOT)),
        hidden=cfg.hidden_size, layers=cfg.num_hidden_layers,
        heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
        vocab=cfg.vocab_size, params=n_params,
        weight_gib=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 2**30,
        init_s=time.perf_counter() - t0)
    pipe = Pipeline(module=model, tokenizer=IdTokenizer(),
                    max_new_tokens=NEW_TOKENS, device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]
    entry = get_entry("decode_attention")
    runs, launches = {}, 0
    for layout in ("paged", "slot"):
        runs[layout], n = serve_run(pipe, layout, prompts, entry)
        launches += n
    same = sum(a == b for a, b in zip(runs["paged"], runs["slot"]))
    say("layouts", paged_equals_slot=f"{same}/{len(prompts)}")
    return model, pipe, prompts, runs, launches


# -- phase 5 ------------------------------------------------------------

def phase_teacher_forced(model, prompts, runs):
    """Re-score every served sequence with ONE cacheless forward (dense
    attention, same weights, same bucket padding and positions). Every
    served token must be that forward's argmax or within TF_MARGIN
    logits of it. The margin covers bf16 rounding, not a fault: the
    served path (cached K/V, the decode kernel's fp32 softmax, GEMMs of
    8 rows) and the re-scoring path (dense attention with bf16
    probabilities, GEMMs of a few hundred rows) round a bf16 residual
    stream differently over 40 layers, and random weights leave top-2
    gaps of a few tenths (the logits' spread is printed). A broken
    kernel or cache picks tokens whole logits below the argmax."""
    import torch
    from fengshen_tpu_torch.serving import BucketLadder
    ladder = BucketLadder()
    gaps, top2, spread, exact, total = [], [], [], 0, 0
    with torch.no_grad():
        for layout, served in runs.items():
            for prompt, tokens in zip(prompts, served):
                bucket = ladder.bucket_for(len(prompt))
                row, mask = ladder.pad_prompt(prompt, bucket)
                ids = torch.tensor(list(row) + tokens[:-1], device="cuda")
                m = torch.tensor(list(mask) + [1] * (len(tokens) - 1),
                                 device="cuda")
                pos = (m.cumsum(0) - 1).clamp(min=0)
                logits = model(ids[None], attention_mask=m[None],
                               position_ids=pos[None])[0].float()
                pred = logits[bucket - 1:]
                chosen = torch.tensor(tokens, device="cuda")
                gap = pred.max(-1).values - pred.gather(
                    1, chosen[:, None])[:, 0]
                best = pred.topk(2, dim=-1).values
                exact += int((pred.argmax(-1) == chosen).sum())
                total += len(tokens)
                gaps.append(float(gap.max()))
                top2.append(float((best[:, 0] - best[:, 1]).median()))
                spread.append(float(pred.std(-1).mean()))
    worst = max(gaps)
    say("teacher_forced", sequences=len(gaps), tokens=total,
        exact_argmax=exact, exact_fraction=exact / total,
        worst_gap=worst, margin=TF_MARGIN,
        median_top2_gap=sorted(top2)[len(top2) // 2],
        logit_std=sum(spread) / len(spread))
    if worst > TF_MARGIN:
        raise AssertionError(f"a served token is {worst} below the "
                             f"teacher-forced argmax (margin {TF_MARGIN})")


# -- phase 6 ------------------------------------------------------------

def phase_profile(pipe, prompts, ticks: int = 8):
    """Where a decode tick's time goes: a paged engine with all 8 lanes
    decoding, ``ticks`` ticks under ``torch.profiler``. Reports wall time
    per tick, device-busy time per tick (sum of kernel self times; one
    stream, so kernels do not overlap), the device's idle share, and the
    kernels that take most device time. Run after the timed phases, so
    its overhead touches no reported number."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fengshen_tpu_torch.api.main import create_continuous_engine
    engine = create_continuous_engine(
        pipe, {"num_slots": 8, "kv_layout": "paged"})
    engine.warmup()
    for p in prompts:
        engine.submit(p, max_new_tokens=NEW_TOKENS)
    engine.step()                       # admits (prefills) all 8 lanes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0) + \
                ev.time_range.elapsed_us()
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    say("profile", layout="paged", lanes=8, ticks=ticks,
        wall_ms_per_tick=wall * 1e3 / ticks,
        device_busy_ms_per_tick=(busy_ms / ticks if kernels else
                                 "not measured: no device events"),
        device_idle_share=(1 - busy_ms / (wall * 1e3) if kernels else
                           "not measured"),
        device_kernels_per_tick=sum(1 for ev in prof.events() if
                                    ev.device_type == DeviceType.CUDA)
        / ticks,
        top_device_ms_per_tick={k[:80]: v / 1e3 / ticks for k, v in top})
    engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import fengshen_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()
    rows = phase_kernels()
    model, pipe, prompts, runs, launches = phase_main_path()
    phase_teacher_forced(model, prompts, runs)
    phase_profile(pipe, prompts)
    from fengshen_tpu_torch.ops.kernels import get_entry
    entry = get_entry("decode_attention")
    main_row = rows[("paged", 1)]
    kernels = [{
        "name": entry.name, "route": "cuda", "source": entry.source,
        "replaces": entry.replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    say("done", seconds=time.perf_counter() - t_start, build_s=build_s,
        card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
