#!/usr/bin/env python3
"""Drive the PyTorch port (``fengshen_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each raises on failure, so any failure exits non-zero):

1. device: torch, CUDA and the card's name and power limit;
2. build: the kernel library from ``fengshen_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, with its time, the plain version's, one
   PyTorch library call's (``library_ms``, a yardstick the port never
   calls) and the bound (the least time the card could take): K3 (paged
   decode attention), then K1 (flash attention: forward, dK/dV, dQ);
4. serving path: Ziya-LLaMA-13B at full width and depth (bf16 weights
   made on the card from a seed) served through the stdlib HTTP server
   and the continuous-batching engine, first over a paged KV pool, then
   over a slot pool; every kernel's launch count is set to 0 just before
   each run and read just after;
5. teacher-forced check: every served sequence re-scored by one
   cacheless forward of the same model;
6. profile: a few decode ticks under ``torch.profiler`` (device busy
   and idle share per tick, the kernels that take the time);
7. fp32 serving bar: a 4-layer model at Ziya width in fp32 (fp32 KV
   pools through K3), its greedy tokens held to the cacheless dense
   forward within a margin derived from fp32 rounding;
8. training path: ``finetune_ziya_llama.main`` at Ziya width with 4
   layers (fp32 master weights, bf16 compute, flash attention through K1,
   gradient checkpointing, AdamW) for 6 steps over one repeated batch
   of 4 x 1024 tokens; counts set to 0 just before and read just after;
   step 1 held to the same step with the plain attention.

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
import math
import subprocess
import tempfile
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
#: fp32 serving bar (phase 7): served fp32 greedy tokens against the
#: cacheless fp32 forward. The two paths sum the same fp32 products in
#: another order (K3's online softmax, GEMMs of other shapes), which
#: moves a logit by ~1e-7 relative per operation, a few 1e-5 after 4
#: layers of 5120-13824-long dot products; 1e-3 leaves that room, and a
#: cache or kernel fault moves a logit by tenths
FP32_MARGIN = 1e-3
FP32_LAYERS = 4

#: H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet), the rate
#: K1's bf16 inputs could be multiplied at
BF16_FLOPS = 989e12
#: K1 against its plain versions, run in fp32 on the same bf16-valued
#: inputs; the backward kernels' plain versions take the kernels' own
#: lse and delta, so each pair computes one function. The kernels round
#: out, dq, dk and dv to bf16 (at most 2^-8 relative) after fp32 sums in
#: another order. Each element must lie within K1_RTOL x (|want| + the
#: rms of want's head_dim row) + 1e-4 x want's rms: a row is one
#: query's out or dq, one key's dk or dv, and a kernel that skips a
#: tile moves its rows by tens of percent (the phase plants such faults
#: and fails unless the check rejects them). Against the attention's
#: gradients by autograd (delta from the unrounded out), each tensor's
#: ||got - want|| / ||want|| must stay under K1_L2_TOL (bf16 rounding
#: alone gives ~2e-3). lse stays fp32: 1e-3 absolute (fast exp/log)
K1_RTOL = 2 ** -7
K1_L2_TOL = 1e-2
K1_LSE_ATOL = 1e-3
#: the kernels' tile, and the tiles the planted faults leave out
K1_TILE = 64
#: training phase (8): steps, layers, batch and sequence
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 6, 4, 1024
#: step 1 with K1 against step 1 with the plain attention (same weights,
#: same batch): each rounds its attention output to bf16 differently.
#: The loss and the global grad norm of the training run's own step 1
#: must agree with the plain step within these relative bounds; the
#: global norm is dominated by the embedding and lm_head, so the check
#: with power is the next one
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
#: every layer's q/k/v/o_proj weight gradient with K1 against the plain
#: step's, both in fp32 compute: ||got - want|| / ||want|| per weight
#: must stay under this. In bf16 compute the two paths' rounding alone
#: gives ~4.6e-2 there, as much as a planted fault, so this check runs
#: in fp32. The phase also plants faults in K1's backward (dq zero; the
#: last 64 query rows of dq zero; the last 64 key rows of dk and dv
#: zero) and fails unless each of them breaks this bound
TRAIN_ATTN_GRAD_RTOL = 1e-3
ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
K1_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")

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


def flash_case(batch, heads, kv_heads, padded, gen):
    """K1 operands at the training shape: S=1024, head_dim 128, bf16,
    with a cotangent; ``padded`` gives segment ids from a right-padded
    mask (rows of 1024, 900, 613 and 77 real tokens; pads are segment 0)."""
    import torch
    S, D = TRAIN_SEQ, 128
    def rnd(h):
        return torch.randn(batch, S, h, D, generator=gen,
                           device="cuda").bfloat16()
    q, k, v, g = rnd(heads), rnd(kv_heads), rnd(kv_heads), rnd(heads)
    seg = None
    if padded:
        lengths = torch.tensor([1024, 900, 613, 77][:batch], device="cuda")
        seg = (torch.arange(S, device="cuda")[None] <
               lengths[:, None]).int()
    return q, k, v, g, seg


def flash_mask(q, k, seg):
    """``[B, 1, Sq, Sk]`` bool: causal and, with segment ids, same
    segment: the pairs the kernels compute."""
    import torch
    S = q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    mask = mask[None, None].expand(q.shape[0], 1, S, S)
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    return mask


def flash_bounds(q, k, seg):
    """Least time of each K1 kernel on these inputs: bytes (each input
    read once, each output written once) over the HBM rate, against the
    multiply-adds over the valid (causal, same-segment) pairs over the
    bf16 tensor-core rate; the larger bounds it."""
    B, S, H, D = q.shape
    pairs = int(flash_mask(q, k, seg).sum()) * H
    elt = q.element_size()
    qb, kvb = q.numel() * elt, 2 * k.numel() * elt
    rows = B * H * S * 4                           # lse or delta, fp32
    segb = 0 if seg is None else 2 * seg.numel() * 4
    work = {"fwd": (qb + kvb + segb + qb + rows, 4 * D * pairs),
            "dkv": (2 * qb + kvb + 2 * rows + segb + kvb, 8 * D * pairs),
            "dq": (2 * qb + kvb + 2 * rows + segb + qb, 6 * D * pairs)}
    out = {}
    for name, (moved, flops) in work.items():
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def k1_reading(got, want) -> dict:
    """``worst``: the largest |got - want| / (K1_RTOL x (|want| + rms of
    want's head_dim row) + 1e-4 x want's rms), at most 1 to pass (the
    last term covers rows that are zero, such as dq's first causal
    row); ``max_abs_err``."""
    diff = (got.float() - want).abs()
    row_rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    limit = K1_RTOL * (want.abs() + row_rms) + 1e-4 * want.pow(2).mean().sqrt()
    return {"worst": (diff / limit).max().item(),
            "max_abs_err": diff.max().item()}


def k1_planted_slices(q, k, v, g, lse, delta):
    """Batch row 0, head 0 of an unpadded causal MHA case, recomputed
    densely in fp32 from the kernels' own lse and delta, as the kernels
    should give it (``sound``) and as kernels that skipped one tile would
    (``fault``): out and dq without k tile [S/2, S/2 + 64) for the q rows
    past it, dk and dv without the last q tile's rows. ``{tensor:
    {"sound": [S, D], "fault": [S, D]}}``."""
    import torch
    S, D = q.shape[1], q.shape[3]
    qs, ks, vs, gs = (t[0, :, 0].float() for t in (q, k, v, g))
    pos = torch.arange(S, device=q.device)
    causal = pos[None] <= pos[:, None]
    lo = S // 2
    tile = ((pos[None] >= lo) & (pos[None] < lo + K1_TILE) &
            (pos[:, None] >= lo + K1_TILE))
    late_rows = (pos >= S - K1_TILE)[:, None]
    scores = qs @ ks.T / math.sqrt(D)

    def out(allowed):
        return torch.softmax(scores.masked_fill(~allowed, -1e30), -1) @ vs

    probs = torch.exp(scores - lse[0, 0][:, None]).masked_fill(~causal, 0)
    ds = probs * (gs @ vs.T - delta[0, 0][:, None]) / math.sqrt(D)
    return {
        "out": {"sound": out(causal), "fault": out(causal & ~tile)},
        "dq": {"sound": ds @ ks, "fault": ds.masked_fill(tile, 0) @ ks},
        "dk": {"sound": ds.T @ qs,
               "fault": ds.masked_fill(late_rows, 0).T @ qs},
        "dv": {"sound": probs.T @ gs,
               "fault": probs.masked_fill(late_rows, 0).T @ gs}}


def phase_flash_kernels():
    """K1 against its plain version at the training shape (B=4, S=1024,
    H=40, D=128, bf16, causal), without and with segment ids from a
    right-padded mask, and one GQA case (KVH=8, B=2). The plain version
    runs in fp32 on the same bf16-valued inputs; the error of the plain
    version run in bf16 is printed beside, for scale. In the unpadded
    case the check is also shown to reject planted faults: one
    (batch row, head) slice of the kernels' results is replaced by a
    dense recomputation with one tile left out (and, as a control,
    without). Times at the padded MHA case, which is what the training
    path gives the kernels; the yardstick is SDPA with ``is_causal``,
    which gives the same answer on every row the loss reads."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, cuda_flash_bwd_dkv, cuda_flash_bwd_dq,
        cuda_flash_fwd, torch_flash_backward, torch_flash_bwd,
        torch_flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    errs = {name: 0.0 for name in K1_NAMES}
    failures = []
    for label, (batch, heads, kv_heads, padded) in {
            "mha": (4, 40, 40, False), "mha_padded": (4, 40, 40, True),
            "gqa_padded": (2, 40, 8, True)}.items():
        q, k, v, g, seg = flash_case(batch, heads, kv_heads, padded, gen)
        out, lse = cuda_flash_fwd(q, k, v, seg, seg, True)
        delta = attention_delta(out, g)
        dk, dv = cuda_flash_bwd_dkv(q, k, v, out, g, lse, delta, seg, seg,
                                    True)
        dq = cuda_flash_bwd_dq(q, k, v, out, g, lse, delta, seg, seg, True)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, g)]
        ref_out, ref_lse = torch_flash_forward(*f32[:3], seg, seg, True)
        # the backward kernels' plain versions on their own inputs (the
        # kernels' lse and delta), and the attention's gradients by
        # autograd with delta from the unrounded out
        ref_grads = torch_flash_bwd(*f32, lse, delta, seg, seg, True)
        auto_grads = torch_flash_backward(*f32, seg, seg, True)
        plain_bf16 = torch_flash_forward(q, k, v, seg, seg, True)[0]
        report = {}
        tensors = {"out": (out, ref_out, ref_out, "flash_attention_fwd"),
                   "dq": (dq, ref_grads[0], auto_grads[0],
                          "flash_attention_bwd_dq"),
                   "dk": (dk, ref_grads[1], auto_grads[1],
                          "flash_attention_bwd_dkv"),
                   "dv": (dv, ref_grads[2], auto_grads[2],
                          "flash_attention_bwd_dkv")}
        for name, (got, want, auto, kernel) in tensors.items():
            if not torch.isfinite(got.float()).all():
                failures.append(f"K1 {label} {name}: non-finite")
            reading = k1_reading(got, want)
            reading["rel_l2_autograd"] = (
                (got.float() - auto).norm() / auto.norm()).item()
            report[name] = reading
            errs[kernel] = max(errs[kernel], reading["max_abs_err"])
            if reading["worst"] > 1.0 or \
                    reading["rel_l2_autograd"] > K1_L2_TOL:
                failures.append(f"K1 {label} {name}: {reading}")
        lse_err = (lse - ref_lse).abs().max().item()
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                          lse_err)
        if lse_err > K1_LSE_ATOL:
            failures.append(f"K1 {label} lse: max abs err {lse_err}")
        report["lse"] = {"max_abs_err": lse_err}
        report["plain_bf16_out"] = k1_reading(plain_bf16, ref_out)
        if label == "mha":
            planted = {}
            for name, cut in k1_planted_slices(q, k, v, g, lse,
                                               delta).items():
                got, want = tensors[name][:2]
                for kind, piece in cut.items():
                    mutant = got.clone()
                    mutant[0, :, 0] = piece.to(mutant.dtype)
                    key = f"{name}_{kind}"
                    planted[key] = k1_reading(mutant, want)
                    if (planted[key]["worst"] <= 1.0) != (kind == "sound"):
                        failures.append(f"K1 planted {key}: the check "
                                        f"gave {planted[key]}")
                    del mutant
            report["planted"] = planted
        del ref_out, ref_lse, ref_grads, auto_grads, f32, plain_bf16
        if label == "mha_padded":
            calls = {
                "flash_attention_fwd": (q, k, v, seg, seg, True),
                "flash_attention_bwd_dkv": (q, k, v, out, g, lse, delta,
                                            seg, seg, True),
                "flash_attention_bwd_dq": (q, k, v, out, g, lse, delta,
                                           seg, seg, True)}
            ms, plain_ms = {}, {}
            for name, call in calls.items():
                entry = get_entry(name)
                ms[name] = cuda_ms(lambda: entry.kernel(*call), 10)
                plain_ms[name] = cuda_ms(lambda: entry.plain(*call), 3)
            # yardstick: SDPA with is_causal on the same inputs, its
            # backward by autograd (dq, dk and dv in one call); beside it
            # SDPA with the exact boolean mask, which keeps it off its
            # flash backend
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            gt = g.transpose(1, 2)
            sdpa = {}
            for how, kw in (("is_causal", {"is_causal": True}),
                            ("masked", {"attn_mask": flash_mask(q, k, seg)})):
                sdpa[f"sdpa_{how}_fwd_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                    20)
                o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
                sdpa[f"sdpa_{how}_bwd_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(o, (qt, kt, vt), gt,
                                                retain_graph=True), 10)
                del o
            bounds = flash_bounds(q, k, seg)
            for name, key, lib in (
                    ("flash_attention_fwd", "fwd",
                     sdpa["sdpa_is_causal_fwd_ms"]),
                    ("flash_attention_bwd_dkv", "dkv",
                     sdpa["sdpa_is_causal_bwd_ms"]),
                    ("flash_attention_bwd_dq", "dq",
                     sdpa["sdpa_is_causal_bwd_ms"])):
                rows[name] = dict(ms=ms[name], plain_ms=plain_ms[name],
                                  library_ms=lib, bound_ms=bounds[key][0],
                                  bound_by=bounds[key][1])
            report["times_ms"], report["plain_ms"] = ms, plain_ms
            report.update(sdpa)
            report["bound_ms"] = {k: b[0] for k, b in bounds.items()}
            report["bound_by"] = {k: b[1] for k, b in bounds.items()}
            report["fraction_of_bound"] = {
                n: rows[n]["bound_ms"] / rows[n]["ms"] for n in rows}
            del qt, kt, vt, gt, calls
        say("kernel", name="flash_attention", case=label,
            shape=list(q.shape), kv_heads=kv_heads,
            segment_ids=seg is not None, rtol=K1_RTOL, l2_tol=K1_L2_TOL,
            **report)
        del q, k, v, g, seg, out, lse, delta, dk, dv, dq, tensors
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    for name in K1_NAMES:
        rows[name]["max_abs_err"] = errs[name]
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

    # the cacheless re-scoring forward (phase 5) is dense: a reference
    # that shares no kernel with the served path
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

def phase_teacher_forced(model, prompts, runs, margin=TF_MARGIN,
                         phase="teacher_forced"):
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
    say(phase, sequences=len(gaps), tokens=total,
        exact_argmax=exact, exact_fraction=exact / total,
        worst_gap=worst, margin=margin,
        median_top2_gap=sorted(top2)[len(top2) // 2],
        logit_std=sum(spread) / len(spread))
    if worst > margin:
        raise AssertionError(f"a served token is {worst} below the "
                             f"teacher-forced argmax (margin {margin})")
    return worst


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


# -- phase 7 ------------------------------------------------------------

def phase_fp32_serving(prompts):
    """A Ziya-width model cut to FP32_LAYERS layers, fp32 weights and so
    fp32 KV pools, served over HTTP by a paged engine through K3; its
    greedy tokens re-scored by the cacheless dense fp32 forward must be
    the argmax or within FP32_MARGIN of it."""
    import torch
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    cfg = dataclasses.replace(LlamaConfig.from_pretrained(str(ZIYA_CONFIG)),
                              num_hidden_layers=FP32_LAYERS,
                              param_dtype="float32", dtype="float32",
                              attention_impl="dense")
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    pipe = Pipeline(module=model, tokenizer=IdTokenizer(),
                    max_new_tokens=NEW_TOKENS, device="cuda")
    served, launches = serve_run(pipe, "paged", prompts,
                                 get_entry("decode_attention"))
    phase_teacher_forced(model, prompts, {"paged": served},
                         margin=FP32_MARGIN, phase="fp32_bar")
    # this bar's own K3 launches; the kernels line counts the main path's
    say("fp32_bar", layers=FP32_LAYERS, decode_attention_launches=launches)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 8 ------------------------------------------------------------

def sft_records(n, vocab, seed):
    """Synthetic SFT records in the ids-as-text form the IdTokenizer
    reads: prompts of 40-300 tokens, answers of 100-1000, so that some
    rows of 1024 are truncated and some are right-padded."""
    import numpy as np
    rng = np.random.RandomState(seed)
    def ids(k):
        return " ".join(map(str, rng.randint(3, vocab, k)))
    return [{"query": ids(rng.randint(40, 300)),
             "answer": ids(rng.randint(100, 1000))} for _ in range(n)]


def attention_grads(model) -> dict:
    """Every layer's q/k/v/o_proj weight gradient, copied."""
    return {name: p.grad.detach().clone()
            for name, p in model.named_parameters()
            if name.split(".")[-2] in ATTN_PROJ}


def grad_rel(got: dict, want: dict) -> dict:
    """``||got - want|| / ||want||`` per weight, the largest over the
    layers for each of q/k/v/o_proj."""
    rel = {proj: 0.0 for proj in ATTN_PROJ}
    for name, w in want.items():
        proj = name.split(".")[-2]
        rel[proj] = max(rel[proj], ((got[name] - w).norm() /
                                    w.norm()).item())
    return rel


def planted_backward_faults():
    """Faults planted in K1's backward for the training step's check:
    name -> patches of the seam's kernel wrappers."""
    import torch
    from fengshen_tpu_torch.ops.kernels import flash_attention as seam
    real_dq, real_dkv = seam.cuda_flash_bwd_dq, seam.cuda_flash_bwd_dkv

    def dq_zero(*a, **kw):
        return torch.zeros_like(real_dq(*a, **kw))

    def dq_last_q_tile_zero(*a, **kw):
        dq = real_dq(*a, **kw)
        dq[:, -K1_TILE:] = 0
        return dq

    def dkv_last_k_tile_zero(*a, **kw):
        dk, dv = real_dkv(*a, **kw)
        dk[:, -K1_TILE:] = 0
        dv[:, -K1_TILE:] = 0
        return dk, dv

    return {"dq_zero": ("cuda_flash_bwd_dq", dq_zero),
            "dq_last_q_tile_zero": ("cuda_flash_bwd_dq",
                                    dq_last_q_tile_zero),
            "dkv_last_k_tile_zero": ("cuda_flash_bwd_dkv",
                                     dkv_last_k_tile_zero)}


def phase_training(workdir: Path):
    """``finetune_ziya_llama.main`` on the card: Ziya width cut to
    TRAIN_LAYERS layers, fp32 master weights, bf16 compute, flash
    attention through K1, gradient checkpointing, AdamW, TRAIN_STEPS
    steps over one batch of 4 x 1024 that repeats (a dataset of exactly
    one batch, many epochs). Then step 1 again from the same seed and
    batch with the plain attention, and in fp32 compute with the plain
    attention, with K1 and with faults planted in K1's backward."""
    import torch
    from unittest import mock
    from fengshen_tpu_torch.examples.ziya_llama import finetune_ziya_llama
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.ops.kernels import (get_entry,
                                                reset_launch_counts)
    from fengshen_tpu_torch.trainer import Trainer

    raw = json.loads(ZIYA_CONFIG.read_text())
    raw["num_hidden_layers"] = TRAIN_LAYERS
    (workdir / "model").mkdir(parents=True, exist_ok=True)
    (workdir / "model" / "config.json").write_text(json.dumps(raw))
    with open(workdir / "sft.jsonl", "w") as f:
        for r in sft_records(TRAIN_BATCH, raw["vocab_size"], seed=4):
            f.write(json.dumps(r) + "\n")
    argv = [str(x) for x in (
        "--model_path", workdir / "model", "--train_file",
        workdir / "sft.jsonl", "--train_batchsize", TRAIN_BATCH,
        "--max_seq_length", TRAIN_SEQ, "--max_steps", TRAIN_STEPS,
        "--max_epochs", 10 * TRAIN_STEPS, "--learning_rate", 3e-4,
        "--scheduler_type", "constant", "--warmup_ratio", 0,
        "--log_every_n_steps", 1, "--seed", 0, "--default_root_dir",
        workdir / "runs", "--device", "cuda")]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = finetune_ziya_llama.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: get_entry(name).launches for name in K1_NAMES}
    peak = torch.cuda.max_memory_allocated()
    steps = [e for e in trainer.history if "loss" in e]
    fit_start = trainer.history[0]
    n_params = fit_start["n_params"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    losses = [e["loss"] for e in steps]
    layers = TRAIN_LAYERS
    want = {"flash_attention_fwd": 2 * layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": layers * TRAIN_STEPS}
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"training: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: the loss on one repeated batch "
                             f"did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"training: K1 launches {launches}, want "
                             f"{want} (forward twice per layer and step: "
                             "the checkpoint recomputes it)")

    # step 1 again on fresh weights from the same seed and the same
    # batch with the plain attention (the dispatch's plain branch); then,
    # in fp32 compute, where rounding leaves K1's gradients distinct from
    # a fault's, with the plain attention, with K1, and with faults
    # planted in K1's backward
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.llama import LlamaConfig
    from fengshen_tpu_torch.ops import kernels
    from fengshen_tpu_torch.ops.kernels import flash_attention as seam
    from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
    args = finetune_ziya_llama.parse_args(argv)
    ref_trainer = Trainer(args)
    collator = finetune_ziya_llama.LlamaSFTCollator(
        IdTokenizer(), max_seq_length=TRAIN_SEQ)
    batch = ref_trainer._to_device(next(iter(UniversalDataModule(
        collate_fn=collator, args=args).train_dataloader())))
    real_tokens = int(batch["attention_mask"].sum())
    def plain_attention():
        return mock.patch.object(kernels, "kernel_choice",
                                 lambda name, tensor: "plain")

    fault_rel = {}
    for dtype in ("bf16", "fp32"):
        config = LlamaConfig.from_pretrained(str(workdir / "model"))
        if dtype == "fp32":
            config = dataclasses.replace(config, dtype="float32")
        module = finetune_ziya_llama.Llama(args, config=config,
                                           device="cuda")
        module.init_params(torch.Generator(device="cuda").manual_seed(0))
        grad_step = ref_trainer._make_grad_step(module)
        with plain_attention():
            ref = grad_step(batch)
        if dtype == "bf16":
            ref_loss, ref_norm = float(ref["loss"]), float(ref["grad_norm"])
        else:
            plain_grads = attention_grads(module.model)
            grad_step(batch)
            attn_rel = grad_rel(attention_grads(module.model), plain_grads)
            for fault, (wrapper, patch) in planted_backward_faults().items():
                with mock.patch.object(seam, wrapper, patch):
                    grad_step(batch)
                fault_rel[fault] = grad_rel(attention_grads(module.model),
                                            plain_grads)
            del plain_grads
        del module, grad_step, ref
        gc.collect()
        torch.cuda.empty_cache()
    del ref_trainer, batch
    loss_rel = abs(steps[0]["loss"] - ref_loss) / abs(ref_loss)
    norm_rel = abs(steps[0]["grad_norm"] - ref_norm) / abs(ref_norm)

    step_s = [e["step_time_s"] for e in steps]
    steady = step_s[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say("train", layers=layers, hidden=raw["hidden_size"],
        heads=raw["num_attention_heads"], vocab=raw["vocab_size"],
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        real_tokens_per_batch=real_tokens, steps=TRAIN_STEPS,
        losses=losses, grad_norms=[e["grad_norm"] for e in steps],
        step_s=step_s, steady_step_s=sum(steady) / len(steady),
        tokens_per_s=tokens * len(steady) / sum(steady),
        real_tokens_per_s=real_tokens * len(steady) / sum(steady),
        mfu_bf16=(steps[-1]["flops_per_token"] * tokens * len(steady) /
                  sum(steady) / BF16_FLOPS),
        wall_s=wall, max_memory_allocated_gib=peak / 2**30,
        launches=launches, plain_step1_loss=ref_loss,
        plain_step1_grad_norm=ref_norm, loss_rel_diff=loss_rel,
        grad_norm_rel_diff=norm_rel, loss_rtol=TRAIN_LOSS_RTOL,
        grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
        attn_grad_rel_diff=attn_rel, attn_grad_rtol=TRAIN_ATTN_GRAD_RTOL,
        planted_fault_attn_grad_rel_diff=fault_rel)
    if loss_rel > TRAIN_LOSS_RTOL or norm_rel > TRAIN_GRAD_NORM_RTOL:
        raise AssertionError(
            f"training: step 1 with K1 (loss {steps[0]['loss']}, grad "
            f"norm {steps[0]['grad_norm']}) against the plain attention "
            f"(loss {ref_loss}, grad norm {ref_norm})")
    if max(attn_rel.values()) > TRAIN_ATTN_GRAD_RTOL:
        raise AssertionError(f"training: step-1 attention weight "
                             f"gradients with K1 against the plain "
                             f"attention: {attn_rel}")
    caught = {f: max(r.values()) > TRAIN_ATTN_GRAD_RTOL
              for f, r in fault_rel.items()}
    if not all(caught.values()):
        raise AssertionError(f"training: a planted K1 backward fault "
                             f"passed the gradient check: {fault_rel}")
    return launches


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
    k1_rows = phase_flash_kernels()
    model, pipe, prompts, runs, launches = phase_main_path()
    phase_teacher_forced(model, prompts, runs)
    phase_profile(pipe, prompts)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    phase_fp32_serving(prompts)
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches = phase_training(Path(tmp))
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
    for name in K1_NAMES:
        e, r = get_entry(name), k1_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": k1_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say("done", seconds=time.perf_counter() - t_start, build_s=build_s,
        card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
