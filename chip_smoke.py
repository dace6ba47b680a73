#!/usr/bin/env python3
"""Drive the PyTorch port (``fengshen_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each raises on failure, so any failure exits non-zero):

1. device: torch, CUDA and the card's name and power limit;
2. build: the kernel library from ``fengshen_tpu_torch/csrc``, with
   each source's compile time and ptxas's registers, spills and shared
   memory per kernel (a redesigned kernel with a stack frame or spills
   fails the run);
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, with its time (the SM clock and power draw
   read before and after), the plain version's, one PyTorch library
   call's (``library_ms``, a yardstick the port never calls) and the
   bound (the least time the card could take): K3 (split-K paged decode
   attention; its split count printed) over bf16 pools (held to the fp32
   plain version too; a planted dropped split must be rejected) and over
   int8 pools with fp32 scales dequantized through bf16 and fp32 (a
   planted scale fault must be rejected), each bitwise equal over two
   calls, then K1 (flash attention: forward, dK/dV, dQ), and K1 timed at
   the long-context attention shape (B 1, S 32768, 32 heads of 128)
   beside SDPA;
4. serving path: Ziya-LLaMA-13B at full width and depth (bf16 weights
   made on the card from a seed) served through the stdlib HTTP server
   and the continuous-batching engine, first over a paged KV pool, then
   over a slot pool; every kernel's launch count is set to 0 just before
   each run and read just after;
5. teacher-forced check: every served sequence re-scored by one
   cacheless forward of the same model; then the same model served from
   int8 KV pools (paged, then slot; K3's int8 branch), its tokens held
   to the bf16 pools' by the reference's margin-aware bar (at the first
   disagreement the bf16 top-2 gap must be within 4x the measured int8
   round-trip noise), and re-scored by one cacheless forward whose
   attention reads K/V as the int8 pool holds them (every token within
   TF_MARGIN of its argmax; a pool served with one KV head's scales
   halved must fail this bar), counts set to 0 just before each run and
   read just after;
5b. speculative and sampled serving: the same model through the HTTP
   server and engine with gamma 4 (K3 verifies windows of S 5):
   prompt_lookup over paged bf16 and int8 pools, self_draft (the first 2
   layers as the draft tower) greedy and sampled (temperature 0.8, top_k
   8) over slot pools, and a plain sampled tick (top_p 0.9, repetition
   penalty 1.1), on prompts of which half repeat a short n-gram. Greedy
   tokens meet the teacher-forced bar (int8: the re-scoring bar), two
   sampled runs under the same request ids give identical tokens, and
   every sampled token lies in the sampler's support of the re-scoring
   forward up to TF_MARGIN; K3's launches are pinned per variant (s5
   per layer per verify tick, s1 per draft layer per draft step); a
   verify that accepts one draft too many, a rollback that skips a
   lane and a sampler that ignores top_k must each fail their bar;
4c. (after 5b) the serving surface, on the same 40-layer bf16 model
   and a paged pool:
   8 concurrent SSE streams over the phase-4 prompts, equal to the
   blocking route's tokens (time to the first ``token`` event printed);
   a client that drops after 10 tokens and reconnects with
   ``Last-Event-ID`` (gapless); ``/partial/<id>`` mid-stream and at the
   end; two ``resume_tokens`` resubmissions (tail identical, or parting
   only at a near-tie of the teacher-forced forward within TF_MARGIN);
   ``/metrics`` counters against ``/stats``; ``POST /debug/dump``; the
   drain with 8 requests in flight (they finish, a new POST and
   ``/healthz`` answer 503 draining, the server stops); one request
   through the ``simple`` engine (the continuous engine's tokens, or
   parting only at such a near-tie); K3's launches pinned as in phase 4
   (one per layer per tick; 40 per decode step of the simple engine);
4d. checkpoint round trip: a 2-layer model at Ziya width (bf16, untied
   head, ~2.1 GB) written as two safetensors shards, loaded with
   ``Pipeline(model=dir, tokenizer=IdTokenizer(), device="cuda")`` (load
   seconds and GiB read printed), every parameter bitwise equal to the
   model written, and both served on the 8 prompts through K3 with equal
   tokens;
6. profile: a few decode ticks under ``torch.profiler``, over a bf16
   and over an int8 paged pool (device busy and idle share per tick,
   K3's time and share of it, the kernels that take the time);
7. fp32 serving bar: a 4-layer model at Ziya width in fp32 (fp32 KV
   pools through K3), its greedy tokens held to the cacheless dense
   forward within a margin derived from fp32 rounding; then served once
   more from an int8 pool, held to the fp32 pool's tokens by the
   margin-aware bar and to the int8 re-scoring (INT8_FP32_MARGIN; the
   planted halved-scale pool must fail it); then, with layers 2-3 made
   the identity, a greedy self_draft engine must accept every draft
   (acceptance 1.0, the bonus token through K3 at S 5) and serve the
   non-spec engine's tokens up to a near-tie within FP32_MARGIN;
8. training path: ``finetune_ziya_llama.main`` at Ziya width with 4
   layers (fp32 master weights, bf16 compute, flash attention through K1,
   gradient checkpointing, AdamW) for 6 steps over one repeated batch
   of 4 x 1024 tokens; counts set to 0 just before and read just after;
   step 1 held to the same step with the plain attention;
9. long-context training path: ``configs/long_context_32k.json`` at full
   width and its full 32768-token window, cut to 4 layers, through the
   kernel bench's ``long_context_fit`` (``Trainer.fit``,
   ``CausalLMModule`` with the fused LM-head CE through K2, ring
   attention on one device through K1, remat ``dots_no_batch``, bf16
   AdamW) for 3 steps; counts set to 0 just before and read just after;
   step 1 held to the same step with K2's plain version, which planted
   K2 faults must fail;
10. LoRA fine-tune: ``finetune_ziya_llama.main`` with ``--packed
   --lora_rank 8`` on Ziya-13B at full width and all 40 layers (fp32
   base made on the card from a seed, bf16 compute, per-layer
   checkpointing), 4 rows of 1024 packed from 14 records, 6 steps,
   validation every 3 steps over 2 batches, ``/metrics`` scraped mid-fit
   and steps 4-5 profiled; K1's launches pinned per step (80 / 40 / 40,
   +40 forward per validation batch), every one given segment ids;
   sampled base tensors bitwise unchanged, every ``lora_b`` moved; step 1
   held to the same step with K1's plain version, which K1 given
   all-ones segment ids (a planted fault) must fail;
11. resume, preemption, rewind and merge on Ziya width cut to 2 layers
   (weights loaded from a safetensors checkpoint the phase writes): a
   run preempted by a real SIGTERM at step 3 and resumed equals the
   uninterrupted run bitwise; a truncated newest checkpoint falls back
   to the one before; NaN steps 5-6 rewind to the step-4 checkpoint and
   dump a flight-recorder bundle; the merge CLI's directory, served
   through ``Pipeline(model=dir)`` and K3 (the CLI run with no
   ``--device``, so on the card), gives the in-memory merge's tokens. Free disk is checked first; GiB and seconds written and read
   are printed.

Phase 3 also holds K2 (fused LM-head cross-entropy: forward, dx, dK) to
its plain version at the long-context path's shape (T = 32767 tokens,
H = 4096, V = 32000, bf16), with planted faults, and drives the
block-sparse path: ``dot_product_attention(impl="sparse")`` forward and
backward by autograd at Ziya's attention width (S = 8192, 40 heads,
head_dim 128, bf16, a BigBird layout of 128-token blocks) through K4
(forward, dK/dV, dQ; the tensor-core variant), counts set to 0 just
before and read just after, the path's forward + backward timed, then
each K4 kernel against its plain version, with planted faults.

It prints one line per phase, then a ``{"kernels": [...]}`` JSON line,
then as its last line ``{"ok": true, "device": {...}}``. Without a card,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import tempfile
import sys
import threading
import time
import urllib.error
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
#: K1 at the long-context path's attention shape (B, S, H, D), causal:
#: timed only (phase 3)
K1_LONG_SHAPE = (1, 32768, 32, 128)
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

K2_NAMES = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dk")
#: K2 at the long-context path's shape: one row of 32768 tokens after
#: the shift by one, hidden 4096, vocab 32000
CE_TOKENS, CE_HIDDEN, CE_VOCAB = 32767, 4096, 32000
#: K2 against its plain version run in fp32 on the same bf16 inputs.
#: lse and gold are fp32 sums of the same 4096 exact products in another
#: order (~1e-6 here): each within CE_STAT_ATOL, which dropping one vocab
#: tile (128 of 32000 columns) from a token's stats exceeds ~40-fold.
#: dx and dK are rounded to bf16 (2^-8 relative): each element within
#: K1_RTOL x (|want| + rms of want's row) + 1e-4 x want's rms, each
#: tensor within K1_L2_TOL relative L2 of autograd through fp32 logits.
#: argmax: exact except where the top two scores lie within
#: CE_ARGMAX_MARGIN (fp32 sums in another order)
CE_STAT_ATOL = 1e-4
CE_ARGMAX_MARGIN = 1e-4
#: long-context phase (9): layers kept of 32, steps
LONG_LAYERS, LONG_STEPS = 4, 3
#: step 1 with K2 against step 1 with K2's plain version in fp32 on the
#: same bf16 inputs (same weights, same batch, the rest of the step the
#: same code): the loss within LONG_LOSS_RTOL; the head gradient and the
#: last layer's o_proj / down_proj gradients within LONG_GRAD_RTOL
#: relative L2. Both round dx and dK to bf16 from fp32 sums in another
#: order, so a few elements move one bf16 ulp; a K2 fault that drops one
#: token tile of dK or of dx moves them by ~sqrt(128 / 32767) = 6 %
LONG_LOSS_RTOL = 1e-5
LONG_GRAD_RTOL = 1e-2
LONG_GRADS = ("lm_head.weight",
              f"model.layers.{LONG_LAYERS - 1}.self_attn.o_proj.weight",
              f"model.layers.{LONG_LAYERS - 1}.mlp.down_proj.weight")
#: the token tile a planted K2 fault leaves out
CE_TILE = 128

NEW_TOKENS = 32
PROMPT_LENGTHS = (5, 40, 64, 65, 100, 130, 200, 300)   # buckets 64..512

#: int8 KV (phases 3, 5, 7): the reference's margin-aware bar. At the
#: first position where an int8 pool's greedy token differs from the
#: unquantized pool's, the unquantized model's teacher-forced top-2 gap
#: must be within INT8_NOISE_SCALE x the measured round-trip noise (the
#: max |logit| change when the cache's K/V go through int8 and back)
INT8_NOISE_SCALE = 4.0
#: the KV head whose scales the planted int8 fault halves
INT8_FAULT_HEAD = 3
#: int8 re-scoring bar of the fp32 4-layer model (phase 7): served int8
#: tokens against a cacheless fp32 forward whose attention reads the
#: same round-tripped K and V. Both paths quantize the same K/V, which
#: they compute with fp32 sums in another order (FP32_MARGIN's 1e-5
#: logits); a value that lands within that of an int8 rounding boundary
#: rounds to the next step (1/127 of its row's max) in one path only,
#: which moves a logit by far less than the round trip's own 0.17-0.21
#: logits. Sound runs on an H100 gave a worst gap of 8.7e-4 (PERF.md,
#: PR 11), so 1e-2 leaves ten times that; the planted halved-scale pool
#: gave 2.94 logits
INT8_FP32_MARGIN = 1e-2

#: speculative and sampled serving (phase 5b): gamma (so K3 verifies
#: windows of S = gamma+1 = 5 rows per KV head), the self-draft tower's
#: depth, and the sampling settings of the sampled runs. Half the prompts
#: are a short random n-gram repeated, so prompt lookup finds matches
SPEC_GAMMA, SPEC_DRAFT_LAYERS = 4, 2
SPEC_NGRAM_PERIODS = (3, 4, 5, 7)
SAMPLE_TEMPERATURE, SAMPLE_TOP_K = 0.8, 8
SAMPLE_TOP_P, SAMPLE_REPETITION_PENALTY = 0.9, 1.1
#: the fp32 model's full-acceptance run (phase 7): new tokens such that
#: every verify tick commits a whole window (1 from the prefill, then
#: ticks of gamma+1), so the acceptance rate over delivered tokens is 1.0
#: exactly when every draft is accepted
FULL_ACCEPT_NEW = 1 + 6 * (SPEC_GAMMA + 1)
#: tokens beyond a sampled run's support margin that the bar replays
#: through a cached decode, worst first, before it fails
REPLAYED_OFFENDERS = 3

K4_NAMES = ("block_sparse_attention_fwd", "block_sparse_attention_bwd_dkv",
            "block_sparse_attention_bwd_dq")
#: K4 at Ziya's attention width: batch 1, 8192 tokens, 40 heads of 128,
#: bf16, 128-token blocks; the layout is BigBird with DeepSpeed's
#: BigBirdSparsityConfig defaults (1 random, 1 global and 3 window
#: blocks), seed 0: 374 of 4096 blocks present
BS_SEQ, BS_HEADS, BS_DIM, BS_BLOCK = 8192, 40, 128, 128
BS_RANDOM, BS_GLOBAL, BS_WINDOW = 1, 1, 3
#: the present block the planted K4 faults drop: (query block, key block)
BS_FAULT_BLOCK = (32, 32)


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


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` captured once in a CUDA graph
    and replayed (CUDA events): the device's time without the host's
    per-call work (the wrapper's checks and allocations), which for a
    kernel of tens of microseconds is as long as the kernel itself.
    Two eager warm-up calls come first, one of them on a side stream as
    capture wants."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


# -- phase 1 ------------------------------------------------------------

def phase_device():
    import importlib.util

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
        count=torch.cuda.device_count(), nvidia_smi=card,
        packages={m: importlib.util.find_spec(m) is not None for m in
                  ("transformers", "safetensors", "sentencepiece")})
    return card


# -- phase 2 ------------------------------------------------------------

def kernel_label(sym: str) -> str:
    """A mangled kernel symbol as its name and template arguments, e.g.
    ``decode_split_kernel<bf16,128,0,1>`` or ``bs_fwd_tc<128>``."""
    short = re.search(r"\d([a-z_]+?)(?:I|E)", sym)
    if not short:
        return sym
    rest = sym[short.end() - 1:]
    if not rest.startswith("I"):
        return short.group(1)
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        m = re.match(r"Li(-?\d+)E", rest[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
            continue
        m = re.match(r"(\d+)", rest[i:])
        if m:
            n, j = int(m.group(1)), i + m.end()
            args.append("bf16" if rest[j:j + n] == "__nv_bfloat16"
                        else rest[j:j + n])
            i = j + n
            continue
        args.append({"f": "float", "i": "int"}.get(rest[i], rest[i]))
        i += 1
    return f"{short.group(1)}<{','.join(args)}>"


def ptxas_report(log: str) -> dict:
    """``nvcc -Xptxas -v`` per kernel: registers, stack frame and spill
    bytes and static shared memory, keyed by :func:`kernel_label`. A
    stack frame means local memory: accumulators indexed at run time
    land there."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = kernel_label(m.group(1))
            continue
        if cur is None:
            continue
        info = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            info["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info["spill_stores"], info["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            info["static_smem"] = int(m.group(1))
    return out


#: dynamic shared memory of the tensor-core kernels, bytes, as their
#: launchers set it (csrc/fused_ce.cu tc::kSmemBytes; csrc/
#: flash_attention.cu tc::fwd_smem / dq_smem / dkv_smem)
TC_DYNAMIC_SMEM = {
    "ce_fwd_tc": 147456, "ce_d_tc": 147456, "ce_dx_tc": 147456,
    "ce_dk_tc": 147456 + 128 * (128 * 2 + 12) + 64,
    **{f"flash_fwd_tc<{d}>": 5 * 64 * d * 2 + 512 for d in (64, 128)},
    **{f"flash_bwd_dq_tc<{d}>": 6 * 64 * d * 2 + 512 for d in (64, 128)},
    **{f"flash_bwd_dkv_tc<{d}>": 6 * 64 * d * 2 + 1536
       for d in (64, 128)},   # dK/dV: + 4 bytes per 32 (head, q tile)
    # csrc/block_sparse_attention.cu tc::fwd_smem / dq_smem / dkv_smem
    **{f"bs_fwd_tc<{d}>": 5 * 64 * d * 2 for d in (64, 128)},
    **{f"bs_bwd_dq_tc<{d}>": 6 * 64 * d * 2 + 512 for d in (64, 128)},
    **{f"bs_bwd_dkv_tc<{d}>": 6 * 64 * d * 2 + 1024 for d in (64, 128)}}
#: the kernels this slice redesigned: none may keep a stack frame or
#: spill (ptxas, phase 2)
NO_STACK_KERNELS = ("decode_split_kernel", "bs_fwd_tc", "bs_bwd_dq_tc",
                    "bs_bwd_dkv_tc")


def phase_build():
    from fengshen_tpu_torch.ops.kernels import build, probe
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    report = ptxas_report(build.last_build_log)
    tensor_core = {name: dict(info, dynamic_smem=TC_DYNAMIC_SMEM.get(name))
                   for name, info in report.items() if "_tc" in name}
    others = {name: info for name, info in report.items()
              if "_tc" not in name}
    checked = {name: info for name, info in report.items()
               if name.split("<")[0] in NO_STACK_KERNELS}
    say("build", seconds=round(seconds, 3), library=build.library_path().name,
        source_seconds={n: round(t, 1)
                        for n, t in build.last_build_seconds.items()},
        ptxas_tensor_core=tensor_core, ptxas_other=others,
        probe=probe().describe())
    bad = {name: info for name, info in checked.items()
           if info.get("stack", 0) or info.get("spill_stores", 0) or
           info.get("spill_loads", 0)}
    if len(checked) < 2 * len(NO_STACK_KERNELS) or bad:
        raise AssertionError(f"ptxas: {len(checked)} redesigned kernels "
                             f"reported; with a stack frame or spills: {bad}")
    return seconds


def clocks() -> dict:
    """The card's SM clock, its maximum and its power draw now, as
    ``nvidia-smi`` reads them (printed beside each phase-3 timing)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    if not out:
        return {"nvidia_smi": "gave nothing"}
    sm, sm_max, power = (x.strip() for x in out[0].split(","))
    return {"sm": sm, "max_sm": sm_max, "power": power}


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


def decode_bound(q, k, valid, table, scale_bytes=0):
    """Least time for one call: the bytes it must move over HBM rate,
    against fp32 flops over the CUDA-core rate; the larger bounds it.
    Counted: q read and out written once, the valid mask and table read
    once, and per lane the K and V rows of every position some query row
    may attend to (a parked lane's output is the mean of ALL its values,
    so its V rows, not its K rows, count), each row with its scales
    (``scale_bytes`` per head: 4 for an int8 pool's fp32 scale)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    L = valid.shape[2]
    row_bytes = KVH * (D * k.element_size() + scale_bytes)
    attended = valid.any(1).sum(1).tolist()               # per lane
    kv = sum(2 * n * row_bytes if n else L * row_bytes for n in attended)
    moved = (2 * q.numel() * q.element_size() + valid.numel() + kv +
             (0 if table is None else table.numel() * 4))
    flops = sum(4 * S * H * D * (n or L) for n in attended)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations", moved


def k3_splits(q, k, valid):
    """K3's split plan for this call: (splits, tiles per split)."""
    import torch
    from fengshen_tpu_torch.ops.kernels import decode_attention as k3
    return k3.split_plan(valid.shape[-1], q.shape[0] * k.shape[2],
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)


def k3_dropped_split(valid, plan):
    """``valid`` with the positions of lane 0's first split that holds a
    valid position masked out: what a combine that lost that split's
    partial would compute."""
    span = plan[1] * 64
    bad = valid.clone()
    for start in range(0, valid.shape[-1], span):
        if bad[0, :, start:start + span].any():
            bad[0, :, start:start + span] = False
            return bad
    raise AssertionError("K3: lane 0 has no valid position")


def phase_kernels():
    """K3 over bf16 pools at decode_case's shapes (slot and paged, S 1 and
    5): the kernel against the plain version on the same bf16 inputs
    (within KERNEL_ATOL) and against the plain version run in fp32 on
    them (k1_reading's element limit, K1_L2_TOL relative L2); two calls
    bitwise equal; a planted fault, the kernel run with one split's
    worth of lane 0's positions masked out (a combine that drops a
    split), must fail the reading. Times of the kernel (replayed from a
    CUDA graph, and called eagerly), the plain version and SDPA over the
    gathered lanes, with the SM clock and power draw read before and
    after the kernel's timing."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels.decode_attention import (
        cuda_decode_attention, torch_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, failures = {}, []
    for layout in ("slot", "paged"):
        for s in (1, 5):
            q, k, v, valid, table = decode_case(layout, s, gen)
            plan = k3_splits(q, k, valid)
            out = cuda_decode_attention(q, k, v, valid, block_table=table)
            again = cuda_decode_attention(q, k, v, valid, block_table=table)
            torch.cuda.synchronize()
            ref = torch_decode_attention(q, k, v, valid, block_table=table)
            ref32 = torch_decode_attention(q.float(), k.float(), v.float(),
                                           valid, block_table=table)
            err = (out.float() - ref.float()).abs().max().item()
            parked_err = (out[7].float() - ref[7].float()).abs().max().item()
            reading = k1_reading(out, ref32)
            reading["rel_l2"] = ((out.float() - ref32).norm() /
                                 ref32.norm()).item()
            planted = k1_reading(cuda_decode_attention(
                q, k, v, k3_dropped_split(valid, plan), block_table=table),
                ref32)
            torch.cuda.synchronize()
            bitwise = torch.equal(out, again)
            if not torch.isfinite(out.float()).all() or err > KERNEL_ATOL \
                    or reading["worst"] > 1.0 or \
                    reading["rel_l2"] > K1_L2_TOL or not bitwise:
                failures.append(f"K3 {layout} S={s}: max abs err {err} "
                                f"(limit {KERNEL_ATOL}), {reading}, "
                                f"bitwise repeat {bitwise}")
            if planted["worst"] <= 1.0:
                failures.append(f"K3 {layout} S={s}: the planted dropped "
                                f"split passed: {planted}")
            clocks_before = clocks()
            ms = graph_ms(lambda: cuda_decode_attention(
                q, k, v, valid, block_table=table), 50)
            clocks_after = clocks()
            eager_ms = cuda_ms(lambda: cuda_decode_attention(
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
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                splits=plan[0])
            say("kernel", name="decode_attention", layout=layout, S=s,
                shape=list(q.shape), pool=list(k.shape), splits=plan[0],
                tiles_per_split=plan[1], max_abs_err=err,
                parked_lane_err=parked_err, tolerance=KERNEL_ATOL,
                fp32_reading=reading, rtol=K1_RTOL, l2_tol=K1_L2_TOL,
                planted_dropped_split=planted, bitwise_repeat=bitwise,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes_moved=moved,
                fraction_of_bound=bound_ms / ms, clocks_before=clocks_before,
                clocks_after=clocks_after)
            del q, k, v, valid, table, out, again, ref, ref32, kg, vg
            del qt, kt, vt
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return rows


def int8_pool(shape, gen):
    """An int8 pool and its fp32 per-(token, head) scales, drawn as
    ``tests/test_pallas_kernels.py`` draws them: values uniform in
    [-127, 127], scales uniform in [0.001, 0.021)."""
    import torch
    values = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int16).to(torch.int8)
    scales = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 \
        + 0.001
    return values, scales


def phase_int8_kernels():
    """K3's int8 branch at decode_case's shapes (8 lanes of 2048, 40
    heads, head_dim 128, bf16 queries, slot and paged, S 1 and 5) over
    int8 pools with random fp32 scales, dequantized through bf16 (the
    serving path's compute dtype) and through fp32. Held to the plain
    version run in fp32 on the same K/V, dequantized and rounded as the
    kernel does (element limit of k1_reading, relative L2 under
    K1_L2_TOL); two calls bitwise equal; a planted fault, one KV head's
    scales halved in the kernel's input only, must be rejected. Times:
    the kernel replayed from a CUDA graph (with the SM clock and power
    draw before and after) and called eagerly, the
    registered plain version on the same inputs, and SDPA over the
    dequantized, gathered lanes (the dequantization not timed)."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv
    from fengshen_tpu_torch.ops.kernels.decode_attention import (
        cuda_decode_attention, torch_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, failures = {}, []
    for dequant in (torch.bfloat16, torch.float32):
        dq_name = str(dequant).split(".")[-1]
        for layout in ("slot", "paged"):
            for s in (1, 5):
                q, kb, _, valid, table = decode_case(layout, s, gen)
                k, ks = int8_pool(kb.shape, gen)
                v, vs = int8_pool(kb.shape, gen)
                del kb
                plan = k3_splits(q, k, valid)
                kw = dict(k_scale=ks, v_scale=vs, block_table=table,
                          dequant_dtype=dequant)
                out = cuda_decode_attention(q, k, v, valid, **kw)
                again = cuda_decode_attention(q, k, v, valid, **kw)
                torch.cuda.synchronize()
                kd = dequantize_kv(k, ks, dequant)
                vd = dequantize_kv(v, vs, dequant)
                ref = torch_decode_attention(q.float(), kd.float(),
                                             vd.float(), valid,
                                             block_table=table)
                reading = k1_reading(out, ref)
                reading["rel_l2"] = ((out.float() - ref).norm() /
                                     ref.norm()).item()
                bitwise = torch.equal(out, again)
                if not torch.isfinite(out.float()).all() or \
                        reading["worst"] > 1.0 or \
                        reading["rel_l2"] > K1_L2_TOL or not bitwise:
                    failures.append(f"K3 int8 {dq_name} {layout} S={s}: "
                                    f"{reading}, bitwise repeat {bitwise}")
                bad = dict(kw, k_scale=ks.clone(), v_scale=vs.clone())
                bad["k_scale"][..., INT8_FAULT_HEAD] *= 0.5
                bad["v_scale"][..., INT8_FAULT_HEAD] *= 0.5
                planted = k1_reading(
                    cuda_decode_attention(q, k, v, valid, **bad), ref)
                torch.cuda.synchronize()
                if planted["worst"] <= 1.0:
                    failures.append(f"K3 int8 {dq_name} {layout} S={s}: the "
                                    f"planted scale fault passed: {planted}")
                clocks_before = clocks()
                ms = graph_ms(lambda: cuda_decode_attention(
                    q, k, v, valid, **kw), 50)
                clocks_after = clocks()
                eager_ms = cuda_ms(lambda: cuda_decode_attention(
                    q, k, v, valid, **kw), 50)
                plain_ms = cuda_ms(lambda: torch_decode_attention(
                    q, k, v, valid, **kw), 5)
                if table is None:
                    kg, vg = kd, vd
                else:
                    idx = (table.long()[:, :, None] * k.shape[1] +
                           torch.arange(k.shape[1], device="cuda")
                           ).flatten(1)
                    kg, vg = kd.flatten(0, 1)[idx], vd.flatten(0, 1)[idx]
                qt, kt, vt = (x.transpose(1, 2).to(q.dtype)
                              for x in (q, kg, vg))
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=valid[:, None]), 20)
                bound_ms, bound_by, moved = decode_bound(q, k, valid, table,
                                                         scale_bytes=4)
                rows[(dq_name, layout, s)] = dict(
                    max_abs_err=reading["max_abs_err"], ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by, splits=plan[0])
                say("kernel", name="decode_attention_int8", layout=layout,
                    S=s, shape=list(q.shape), pool=list(k.shape),
                    pool_dtype="int8", dequant_dtype=dq_name,
                    splits=plan[0], tiles_per_split=plan[1], rtol=K1_RTOL,
                    l2_tol=K1_L2_TOL, **reading, bitwise_repeat=bitwise,
                    planted_scale_fault=planted, ms=ms, eager_ms=eager_ms,
                    plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bytes_moved=moved,
                    fraction_of_bound=bound_ms / ms,
                    clocks_before=clocks_before, clocks_after=clocks_after)
                del q, k, v, ks, vs, kd, vd, valid, table, out, again, ref
                del kg, vg, qt, kt, vt, kw, bad
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
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
    pairs = (B * S * (S + 1) // 2 if seg is None else
             int(flash_mask(q, k, seg).sum())) * H
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
    k1_long_context(gen)
    return rows


def k1_long_context(gen):
    """K1 at the long-context path's attention shape (B 1, S 32768, 32
    heads of 128, causal, bf16): the three kernels' times against SDPA
    with ``is_causal`` (forward; backward by autograd, dq, dk and dv in
    one call) and the bound. No plain version at this size."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, cuda_flash_bwd_dkv, cuda_flash_bwd_dq,
        cuda_flash_fwd)
    B, S, H, D = K1_LONG_SHAPE
    pairs = B * H * S * (S + 1) // 2
    q, k, v, g = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    out, lse = cuda_flash_fwd(q, k, v, None, None, True)
    delta = attention_delta(out, g)
    ms = {"flash_attention_fwd": cuda_ms(
              lambda: cuda_flash_fwd(q, k, v, None, None, True), 3),
          "flash_attention_bwd_dkv": cuda_ms(
              lambda: cuda_flash_bwd_dkv(q, k, v, out, g, lse, delta,
                                         causal=True), 3),
          "flash_attention_bwd_dq": cuda_ms(
              lambda: cuda_flash_bwd_dq(q, k, v, out, g, lse, delta,
                                        causal=True), 3)}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 3)
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), g.transpose(1, 2), retain_graph=True), 3)
    bounds = flash_bounds(q, k, None)
    say("kernel", name="flash_attention", case="long_context",
        shape=list(q.shape), causal=True, variant="tensor_core",
        times_ms=ms, sdpa_is_causal_fwd_ms=sdpa_fwd,
        sdpa_is_causal_bwd_ms=sdpa_bwd,
        bound_ms={n: b[0] for n, b in bounds.items()},
        bound_by={n: b[1] for n, b in bounds.items()},
        tflops={name: flops * D * pairs / ms[name] / 1e9
                for name, flops in zip(K1_NAMES, (4, 8, 6))},
        finite=finite)
    del q, k, v, g, out, lse, delta, qt, kt, vt, o
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("K1 at 32k: non-finite out or lse")


# -- phase 4 ------------------------------------------------------------

def post(port: int, text: str, request_id=None,
         max_new: int = NEW_TOKENS) -> tuple:
    payload = {"input_text": text, "max_new_tokens": max_new}
    if request_id is not None:
        payload["request_id"] = request_id
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/text_generation", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t0


def serve_run(pipe, layout: str, prompts, entry, kv_dtype: str = "fp32",
              engine_args=None, request_ids=None, max_new: int = NEW_TOKENS,
              stats_out=None):
    """One engine + server on port 0; 8 concurrent POSTs. Returns the
    served token ids per prompt and the launch count of the run.
    ``kv_dtype`` "fp32" keeps the pool in the model's compute dtype;
    "int8" quantizes it. ``engine_args`` adds engine options (sampling,
    ``spec_mode``); ``request_ids`` names the requests (a sampled
    request's seed derives from its id). K3's launches are pinned per
    query-window variant: a plain tick is one ``s1`` launch per layer; a
    speculative tick one ``s{gamma+1}`` launch per layer, plus, under
    ``self_draft``, gamma+1 ``s1`` launches per draft layer. The run's
    ``/stats`` difference goes into ``stats_out`` when given."""
    import torch
    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             build_stdlib_server,
                                             start_continuous_engine)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    engine_args = dict(engine_args or {})
    engine = start_continuous_engine(
        pipe, {"num_slots": 8, "kv_layout": layout, "max_queue": 16,
               "kv_dtype": kv_dtype, **engine_args})
    ids = request_ids or [None] * len(prompts)
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
                lambda a: post(port, " ".join(map(str, a[0])), a[1],
                               max_new), zip(prompts, ids)))
        wall = time.perf_counter() - t0
        launches, dense_calls = entry.launches, entry.dense_calls
        variants = dict(entry.variants)
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
        if status != 200 or body["generated_tokens"] != max_new:
            raise AssertionError(f"{layout}: {status} {body}")
        served.append([int(t) for t in body["result"].split()])
    layers = pipe.module.config.num_hidden_layers
    mode = engine_args.get("spec_mode", "off")
    gamma = engine_args.get("spec_gamma", 4)
    if mode == "off":
        want = {"s1": layers * ticks}
        min_ticks = max_new - 1
    else:
        want = {f"s{gamma + 1}": layers * ticks}
        if mode == "self_draft":
            want["s1"] = engine_args.get("spec_draft_layers", 2) * \
                (gamma + 1) * ticks
        min_ticks = math.ceil((max_new - 1) / (gamma + 1))
    if ticks < min_ticks or variants != want or \
            launches != sum(want.values()):
        raise AssertionError(
            f"{layout} {mode}: decode-kernel launches {variants} over "
            f"{ticks} ticks; want {want}: every layer of every tick "
            f"launches it, a verify window at S = gamma+1")
    if dense_calls != layers * prefills:
        raise AssertionError(f"{layout}: {dense_calls} dense-route calls "
                             f"for {prefills} prefills")
    if stats_out is not None:
        stats_out.update(variants=variants, ticks=ticks,
                         spec_acceptance_rate=after.get(
                             "spec_acceptance_rate"))
    tokens = max_new * len(prompts)
    # a spec engine's acceptance counts only its own run (the warmup tick
    # records none)
    spec = {} if mode == "off" else dict(
        spec_mode=mode, gamma=gamma,
        acceptance_rate=after["spec_acceptance_rate"],
        drafted=after["spec_drafted_total"],
        accepted=after["spec_accepted_total"],
        tokens_per_tick_all_lanes=(
            (after["decode_tokens"] - before["decode_tokens"]) / ticks))
    say("serve", layout=layout, kv_dtype=kv_dtype, requests=len(prompts),
        engine_args=engine_args, variants=variants, **spec,
        prompt_tokens=[len(p) for p in prompts],
        buckets=sorted(after["prefills_per_bucket"]),
        generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        decode_ticks=ticks, decode_ms_per_tick=(
            (after["decode_seconds"] - before["decode_seconds"]) * 1e3 /
            ticks), decode_tokens_per_s_engine=(
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

@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def int8_pool_reads(split: int):
    """Inside the block the model's cacheless dense attention reads K and
    V as an int8 serving pool holds them: query rows from ``split`` on
    (the generated tokens, which decode from the pool) attend to K and V
    round-tripped through ``quantize_kv`` / ``dequantize_kv``; rows
    before it (the bucket-padded prompt, which the engine prefills with
    unquantized K/V before it quantizes them into the pool) to K and V
    as computed."""
    import torch
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv, quantize_kv
    dense = modeling_llama.dot_product_attention

    def roundtrip(t):
        return dequantize_kv(*quantize_kv(t), t.dtype)

    def attention(q, k, v, **kw):
        out = dense(q, k, v, **kw)
        pool = dense(q, roundtrip(k), roundtrip(v), **kw)
        return torch.cat([out[:, :split], pool[:, split:]], dim=1)

    with patched(modeling_llama, "dot_product_attention", attention):
        yield


@contextlib.contextmanager
def int8_scale_fault():
    """Inside the block every int8 pool write (the slot and paged decode
    writes and the paged prefill copy) stores KV head INT8_FAULT_HEAD's
    scales halved: phase 3's planted K3-int8 fault, moved into the
    served pool."""
    from fengshen_tpu_torch.models.llama import modeling_llama
    from fengshen_tpu_torch.serving import paged_cache
    from fengshen_tpu_torch.ops.int8_matmul import quantize_kv

    def faulty(x):
        values, scale = quantize_kv(x)
        scale = scale.clone()
        scale[..., INT8_FAULT_HEAD] *= 0.5
        return values, scale

    with patched(modeling_llama, "quantize_kv", faulty), \
            patched(paged_cache, "quantize_kv", faulty):
        yield


def phase_teacher_forced(model, prompts, runs, margin=TF_MARGIN,
                         phase="teacher_forced", int8_pool=False,
                         check=True):
    """Re-score every served sequence with ONE cacheless forward (dense
    attention, same weights, same bucket padding and positions). Every
    served token must be that forward's argmax or within TF_MARGIN
    logits of it. The margin covers bf16 rounding, not a fault: the
    served path (cached K/V, the decode kernel's fp32 softmax, GEMMs of
    8 rows) and the re-scoring path (dense attention with bf16
    probabilities, GEMMs of a few hundred rows) round a bf16 residual
    stream differently over 40 layers, and random weights leave top-2
    gaps of a few tenths (the logits' spread is printed). A broken
    kernel or cache picks tokens whole logits below the argmax. With
    ``int8_pool`` the re-scoring's attention reads K and V as an int8
    pool holds them (:func:`int8_pool_reads`). Returns the worst gap;
    raises when it passes ``margin``, unless ``check`` is False."""
    import torch
    gaps, top2, spread, exact, total = [], [], [], 0, 0
    with torch.no_grad():
        for layout, served in runs.items():
            for prompt, tokens in zip(prompts, served):
                pred, _ = rescored(model, prompt, tokens, int8_pool)
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
    if check and worst > margin:
        raise AssertionError(f"a served token is {worst} below the "
                             f"teacher-forced argmax (margin {margin})")
    return worst


def rescored(model, prompt, tokens, int8_pool=False):
    """One cacheless forward (dense attention, same weights, the engine's
    bucket padding and positions) over a served sequence. Returns the
    fp32 logits that scored each served token ``[T, V]`` and the
    sequence's history as the engine held it when it chose them: the
    padded prompt and its mask, then the tokens (``ids``, ``mask``,
    ``bucket``)."""
    import torch
    from fengshen_tpu_torch.serving import BucketLadder
    ladder = BucketLadder()
    bucket = ladder.bucket_for(len(prompt))
    row, mask = ladder.pad_prompt(prompt, bucket)
    ids = torch.tensor(list(row) + tokens[:-1], device="cuda")
    m = torch.tensor(list(mask) + [1] * (len(tokens) - 1), device="cuda")
    pos = (m.cumsum(0) - 1).clamp(min=0)
    with (int8_pool_reads(bucket) if int8_pool
          else contextlib.nullcontext()):
        logits = model(ids[None], attention_mask=m[None],
                       position_ids=pos[None])[0].float()
    return logits[bucket - 1:], (ids, m, bucket)


def kv_roundtrip_noise(model, seq) -> float:
    """The int8-KV logit perturbation, measured as the reference's
    ``_kv_roundtrip_noise`` (tests/test_serving_paged.py:194) does:
    prime a cache on ``seq[:-1]``, round its K/V through the pool's
    per-(token, head) quantization, decode one step both ways, and take
    the max |logit| difference."""
    import torch
    from fengshen_tpu_torch.models.llama.modeling_llama import KVCache
    from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv, quantize_kv
    from fengshen_tpu_torch.utils.generate import _prefill_cache
    dev = model.device
    ids = torch.tensor(list(seq[:-1]), device=dev)[None]
    mask = torch.ones_like(ids)
    _, cache = _prefill_cache(model, ids, mask,
                              torch.arange(ids.shape[1], device=dev)[None])

    def step(roundtrip):
        def kv(t):
            return dequantize_kv(*quantize_kv(t), t.dtype) if roundtrip \
                else t.clone()
        c = KVCache([kv(t) for t in cache.keys],
                    [kv(t) for t in cache.values], cache.index)
        return model(torch.tensor([[int(seq[-1])]], device=dev),
                     attention_mask=mask,
                     position_ids=torch.tensor([[len(seq) - 1]], device=dev),
                     cache=c)[0, -1].float()
    with torch.no_grad():
        return float((step(False) - step(True)).abs().max())


def first_disagreement(model, prompt, ref_tokens, test_tokens):
    """The reference's margin-aware bar (tests/test_serving_paged.py:
    225-250) for one sequence: None where the int8 stream equals the
    unquantized one; else the first disagreeing position, the
    unquantized model's teacher-forced top-2 gap there (one cacheless
    forward of the unpadded sequence), the measured round-trip noise on
    that prefix, and whether the gap is within INT8_NOISE_SCALE x the
    noise. Positions after the first are autoregressive drift and are
    not judged."""
    import torch
    for t, (a, b) in enumerate(zip(ref_tokens, test_tokens)):
        if a == b:
            continue
        seq = list(prompt) + list(ref_tokens[:t + 1])
        with torch.no_grad():
            logits = model(torch.tensor(seq, device=model.device)[None])[0]
        top2 = logits[len(prompt) + t - 1].float().topk(2).values
        margin = float(top2[0] - top2[1])
        noise = kv_roundtrip_noise(model, seq[:len(prompt) + t])
        return {"position": t, "margin": margin, "noise": noise,
                "ok": margin <= INT8_NOISE_SCALE * noise}
    return None


def int8_bar(model, prompts, ref_runs, int8_runs, phase):
    """Hold every int8-served sequence to the unquantized one served for
    the same prompt and layout with :func:`first_disagreement`."""
    verdicts = {}
    for layout, served in int8_runs.items():
        verdicts[layout] = [
            first_disagreement(model, p, ref, got)
            for p, ref, got in zip(prompts, ref_runs[layout], served)]
    identical = {layout: sum(v is None for v in vs)
                 for layout, vs in verdicts.items()}
    say(phase, noise_scale=INT8_NOISE_SCALE,
        identical_sequences=identical, sequences=len(prompts),
        first_disagreements={layout: [v for v in vs if v is not None]
                             for layout, vs in verdicts.items()})
    bad = [v for vs in verdicts.values() for v in vs
           if v is not None and not v["ok"]]
    if bad:
        raise AssertionError(f"{phase}: int8 KV flipped a confident "
                             f"position: {bad}")


def int8_rescoring_bar(model, pipe, prompts, int8_runs, margin, phase):
    """The int8-served sequences re-scored by one cacheless forward whose
    attention reads K and V as the pool holds them: every served token
    is that forward's argmax or within ``margin`` of it. Then the same
    model served once more from a paged int8 pool with the halved-scale
    fault planted in every pool write; the bar must reject those tokens
    (their worst gap must pass ``margin``), or the phase fails."""
    from fengshen_tpu_torch.ops.kernels import get_entry
    sound = phase_teacher_forced(model, prompts, int8_runs, margin=margin,
                                 phase=phase, int8_pool=True)
    with int8_scale_fault():
        faulty, _ = serve_run(pipe, "paged", prompts,
                              get_entry("decode_attention"),
                              kv_dtype="int8")
    planted = phase_teacher_forced(model, prompts, {"paged": faulty},
                                   margin=margin, phase=f"{phase}_planted",
                                   int8_pool=True, check=False)
    say(phase, sound_worst_gap=sound, planted_worst_gap=planted,
        margin=margin, planted_rejected=planted > margin)
    if planted <= margin:
        raise AssertionError(f"{phase}: the planted halved-scale pool "
                             f"passed the re-scoring bar (worst gap "
                             f"{planted}, margin {margin})")


def phase_int8_serving(model, pipe, prompts, runs):
    """The 40-layer bf16 model served again from int8 KV pools (paged,
    then slot) through the HTTP server and engine: K3's int8 branch on
    every layer of every tick (serve_run pins 40 launches per tick and
    prints tokens/s, TTFT, peak memory and the pool's bytes), its tokens
    held to the bf16 pools' tokens by the margin-aware bar, and to a
    re-scoring that reads the pool's K and V (int8_rescoring_bar)."""
    from fengshen_tpu_torch.ops.kernels import get_entry
    entry = get_entry("decode_attention")
    int8_runs, launches = {}, 0
    for layout in ("paged", "slot"):
        int8_runs[layout], n = serve_run(pipe, layout, prompts, entry,
                                         kv_dtype="int8")
        launches += n
    int8_bar(model, prompts, runs, int8_runs, "int8_bar")
    int8_rescoring_bar(model, pipe, prompts, int8_runs, TF_MARGIN,
                       "int8_rescore")
    return launches


# -- phase 5b -----------------------------------------------------------

def spec_prompts(vocab: int):
    """PROMPT_LENGTHS' lengths; every other prompt is a random n-gram of
    SPEC_NGRAM_PERIODS' length repeated, the rest random tokens."""
    import numpy as np
    rng = np.random.RandomState(5)
    prompts = []
    for i, n in enumerate(PROMPT_LENGTHS):
        if i % 2:
            prompts.append(rng.randint(3, vocab, n).tolist())
        else:
            gram = rng.randint(3, vocab, SPEC_NGRAM_PERIODS[i // 2 % 4])
            prompts.append(np.resize(gram, n).tolist())
    return prompts


def support_bar(model, prompts, served, phase, *, top_k=0, top_p=0.0,
                temperature=1.0, repetition_penalty=1.0, margin=TF_MARGIN,
                check=True):
    """Sampled tokens re-scored by one cacheless forward (:func:`rescored`;
    the repetition penalty applied to its logits as the engine applied
    it, over the padded prompt and the tokens before each): every served
    token must lie in the sampler's support up to ``margin``, i.e. its
    logit is at least the support's lowest logit (the top_k-th largest,
    or the smallest logit of top_p's nucleus) minus ``margin``. Returns
    the worst shortfall; raises when it passes ``margin``, unless
    ``check`` is False."""
    import torch
    from fengshen_tpu_torch.utils.generate import (apply_logits_controls,
                                                   top_p_logits)
    worst, outside, total = -math.inf, 0, 0
    offenders = []
    with torch.no_grad():
        for prompt, tokens in zip(prompts, served):
            pred, (ids, mask, bucket) = rescored(model, prompt, tokens)
            n = len(tokens)
            if repetition_penalty != 1.0:
                cur = torch.arange(bucket, bucket + n, device="cuda")
                pred = apply_logits_controls(
                    pred, ids[None].expand(n, -1), cur[:, None],
                    history_mask=mask[None].expand(n, -1),
                    repetition_penalty=repetition_penalty)
            if top_k:
                floor = pred.topk(top_k, dim=-1).values[:, -1]
            else:
                kept = top_p_logits(pred / temperature, top_p) > -1e8
                floor = torch.where(kept, pred, math.inf).min(-1).values
            chosen = pred.gather(
                1, torch.tensor(tokens, device="cuda")[:, None])[:, 0]
            short = floor - chosen
            outside += int((short > 0).sum())
            total += n
            for j in (short > 0).nonzero()[:, 0].tolist():
                offenders.append((float(short[j]), j, tokens[j], ids, mask,
                                  bucket, pred[j], float(chosen[j]),
                                  float(floor[j])))
            worst = max(worst, float(short.max()))
        # when the bar is about to fail, its worst offenders are replayed
        # through a cached decode: is the token outside the support of
        # the served path's arithmetic too (a sampler fault), or only of
        # the cacheless re-scoring (rounding)?
        offenders.sort(key=lambda o: -o[0])
        shown = [dict(shortfall=o[0], position=o[1], chosen_logit=o[7],
                      floor=o[8],
                      replay=replay_position(
                          model, o[3], o[4], o[5], o[1], o[2], top_k,
                          top_p, temperature, repetition_penalty, o[6])
                      if check and o[0] > margin and
                      i < REPLAYED_OFFENDERS else None)
                 for i, o in enumerate(offenders[:8])]
    say(phase, sequences=len(served), tokens=total, top_k=top_k,
        top_p=top_p, temperature=temperature,
        repetition_penalty=repetition_penalty, worst_shortfall=worst,
        outside_support=outside, margin=margin, worst_offenders=shown)
    if check and worst > margin:
        raise AssertionError(f"{phase}: a sampled token lies {worst} "
                             f"logits outside the support (margin "
                             f"{margin})")
    return worst


def replay_position(model, ids, mask, bucket, j, token, top_k, top_p,
                    temperature, repetition_penalty, rescore):
    """Diagnostic: the logits of generated position ``j`` by a batch-1
    cached decode (prefill, then one K3 step per token, the served
    path's arithmetic), against the cacheless re-scoring ``rescore``:
    the largest difference, the difference at ``token``, and whether
    ``token`` lies in the replay's own support."""
    import torch
    from fengshen_tpu_torch.utils.generate import (_prefill_cache,
                                                   apply_logits_controls,
                                                   top_p_logits)
    pos = (mask.cumsum(0) - 1).clamp(min=0)
    logits, cache = _prefill_cache(model, ids[None, :bucket],
                                   mask[None, :bucket], pos[None, :bucket])
    for t in range(bucket, bucket + j):
        logits = model(ids[None, t:t + 1], attention_mask=mask[None, :bucket],
                       position_ids=pos[None, t:t + 1], cache=cache)
    step = logits[0, -1].float()
    if repetition_penalty != 1.0:
        step = apply_logits_controls(
            step[None], ids[None], bucket + j, history_mask=mask[None],
            repetition_penalty=repetition_penalty)[0]
    if top_k:
        floor = step.topk(top_k).values[-1]
    else:
        kept = top_p_logits(step[None] / temperature, top_p)[0] > -1e8
        floor = torch.where(kept, step, math.inf).min()
    diff = step - rescore
    return dict(max_abs_diff=float(diff.abs().max()),
                diff_at_token=float(diff[token]),
                in_replay_support=bool(step[token] >= floor),
                replay_shortfall=float(floor - step[token]))


def accept_one_beyond(round_tokens):
    """A planted verify fault: every lane with a rejection accepts one
    draft more than matched (its rejected draft commits)."""
    import torch

    def faulty(t_logits, d_logits, d, rng, **kw):
        n_r, w = round_tokens(t_logits, d_logits, d, rng, **kw)
        gamma = d.shape[1]
        lanes = torch.arange(d.shape[0], device=d.device)
        short = n_r < gamma
        w = w.clone()
        w[lanes[short], n_r[short]] = d[lanes[short], n_r[short]]
        return torch.where(short, n_r + 1, n_r), w
    return faulty


def rollback_skipping_a_lane(rollback):
    """A planted rollback fault: the first active lane with a rejected
    tail keeps it (its cursor is not lowered)."""
    def faulty(cache, delta):
        delta = delta.clone()
        rolled = (delta > 0).nonzero()
        if len(rolled):
            delta[rolled[0, 0]] = 0
        rollback(cache, delta)
    return faulty


def top_k_ignored(top_k_logits):
    """A planted sampler fault: top-k filtering does nothing."""
    def faulty(logits, k=0, p=0.0, filter_value=-1e9):
        return top_k_logits(logits, 0, p, filter_value)
    return faulty


def planted_serving_fault(name, patch, run, bar):
    """Serve with one fault planted (``patch`` a context manager) and
    hold the tokens to ``bar(tokens, check=False)``: the bar must reject
    them, or the phase fails."""
    with patch:
        served = run()
    worst = bar(served)
    say("spec_planted", fault=name, worst=worst, margin=TF_MARGIN,
        rejected=worst > TF_MARGIN)
    if worst <= TF_MARGIN:
        raise AssertionError(f"planted fault {name!r} passed its bar "
                             f"(worst {worst}, margin {TF_MARGIN})")


def phase_spec_serving(model, pipe, card):
    """The 40-layer bf16 model served with speculative and sampled ticks
    through the HTTP server and engine (8 slots, gamma 4, 32 new tokens):

    1. prompt_lookup, greedy, paged bf16 pool: teacher-forced bar; K3
       launches exactly 40 x verify ticks at s5 and none at s1;
    2. prompt_lookup over a paged int8 pool: the int8 re-scoring bar;
    3. self_draft (2 layers), greedy, slot bf16 pool: teacher-forced bar;
       K3 launches (40 at s5 + 2 x 5 at s1) x ticks;
    4. sampled self_draft (temperature 0.8, top_k 8): two runs under the
       same request ids give bitwise-identical tokens; every token lies
       in the top-8 of the re-scoring forward, up to TF_MARGIN;
    5. a plain sampled tick (top_p 0.9, repetition penalty 1.1): the
       same support bar with top_p's nucleus.

    Then the three planted faults (a verify that accepts one draft beyond
    the matched prefix, a rollback that skips one active lane, a sampler
    that ignores top_k) must each fail its bar. Returns the s5 launches
    per pool dtype (bf16, int8)."""
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.serving import engine as engine_mod
    from fengshen_tpu_torch.utils import generate as generate_mod
    entry = get_entry("decode_attention")
    prompts = spec_prompts(model.config.vocab_size)
    spec = {"spec_gamma": SPEC_GAMMA}
    lookup = {**spec, "spec_mode": "prompt_lookup"}
    draft = {**spec, "spec_mode": "self_draft",
             "spec_draft_layers": SPEC_DRAFT_LAYERS}
    top_k = {"do_sample": True, "temperature": SAMPLE_TEMPERATURE,
             "top_k": SAMPLE_TOP_K}
    nucleus = {"do_sample": True, "top_p": SAMPLE_TOP_P,
               "repetition_penalty": SAMPLE_REPETITION_PENALTY}
    ids = [f"spec-{i}" for i in range(len(prompts))]
    s5 = f"s{SPEC_GAMMA + 1}"
    verify = {"bfloat16": 0, "int8": 0}

    def run(layout, args, kv_dtype="fp32", count=True):
        stats = {}
        served, _ = serve_run(pipe, layout, prompts, entry, kv_dtype,
                              engine_args=args, request_ids=ids,
                              stats_out=stats)
        if count:
            verify["int8" if kv_dtype == "int8" else "bfloat16"] += \
                stats["variants"].get(s5, 0)
        return served

    lookup_paged = run("paged", lookup)
    phase_teacher_forced(model, prompts, {"lookup_paged": lookup_paged},
                         phase="spec_lookup_tf")
    lookup_int8 = run("paged", lookup, "int8")
    phase_teacher_forced(model, prompts, {"lookup_int8": lookup_int8},
                         phase="spec_lookup_int8_rescore", int8_pool=True)
    draft_slot = run("slot", draft)
    phase_teacher_forced(model, prompts, {"draft_slot": draft_slot},
                         phase="spec_draft_tf")
    sampled = [run("slot", {**draft, **top_k}) for _ in range(2)]
    identical = sampled[0] == sampled[1]
    say("spec_sampled_repeat", bitwise_identical=identical,
        sequences=len(prompts), card=card)
    if not identical:
        raise AssertionError("two sampled self_draft runs under the same "
                             "request ids gave different tokens")
    support_bar(model, prompts, sampled[0], "spec_sampled_support",
                top_k=SAMPLE_TOP_K, temperature=SAMPLE_TEMPERATURE)
    plain = run("paged", nucleus)
    support_bar(model, prompts, plain, "sampled_nucleus_support",
                top_p=SAMPLE_TOP_P,
                repetition_penalty=SAMPLE_REPETITION_PENALTY)

    def tf(served):
        return phase_teacher_forced(model, prompts, {"planted": served},
                                    phase="spec_planted_tf", check=False)
    planted_serving_fault(
        "verify accepts one draft beyond the matched prefix",
        patched(engine_mod, "_spec_round_tokens",
                accept_one_beyond(engine_mod._spec_round_tokens)),
        lambda: run("paged", lookup, count=False), tf)
    planted_serving_fault(
        "rollback skips one active lane",
        patched(engine_mod, "rollback_slots",
                rollback_skipping_a_lane(engine_mod.rollback_slots)),
        lambda: run("paged", lookup, count=False), tf)
    planted_serving_fault(
        "sampler ignores top_k",
        patched(generate_mod, "top_k_logits",
                top_k_ignored(generate_mod.top_k_logits)),
        lambda: run("slot", {**draft, **top_k}, count=False),
        lambda served: support_bar(
            model, prompts, served, "spec_planted_support",
            top_k=SAMPLE_TOP_K, temperature=SAMPLE_TEMPERATURE,
            check=False))
    return verify


# -- phase 4c -----------------------------------------------------------

def sse_post(port: int, payload: dict, headers=None, limit=None) -> tuple:
    """POST to the stream route; returns (tokens, frames, seconds to the
    first ``token`` frame). With ``limit`` the client drops the
    connection after that many token frames."""
    from fengshen_tpu_torch.streaming import iter_sse
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/text_generation/stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    frames, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        for frame in iter_sse(r):
            if frame["event"] == "token" and first is None:
                first = time.perf_counter() - t0
            frames.append(frame)
            if limit is not None and len(frames) == limit:
                break
    toks = [f for f in frames if f["event"] == "token"]
    if toks and [f["id"] for f in toks] != list(
            range(toks[0]["id"], toks[0]["id"] + len(toks))):
        raise AssertionError(f"stream ids have a gap: "
                             f"{[f['id'] for f in toks]}")
    return [f["data"]["token"] for f in toks], frames, first


def http_json(port: int, path: str, payload=None) -> tuple:
    """(status, parsed body) of a GET (``payload`` None) or POST."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    return code, (json.loads(raw) if "json" in ctype else raw.decode())


def near_tie(model, prompt, want, got) -> dict:
    """Where two greedy sequences for ``prompt`` part: None when equal;
    else the first differing position and the top-2 gap there of one
    cacheless forward over ``want`` (the engine's bucket padding), and
    whether it is within TF_MARGIN (a near-tie that bf16 rounding of two
    computation orders may flip; a fault flips confident tokens)."""
    import torch
    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             None)
    if t is None and len(want) == len(got):
        return None
    if t is None:
        return {"position": min(len(want), len(got)), "gap": None,
                "ok": False}
    with torch.no_grad():
        pred, _ = rescored(model, prompt, list(want))
    top2 = pred[t].topk(2).values
    gap = float(top2[0] - top2[1])
    return {"position": t, "gap": gap, "ok": gap <= TF_MARGIN}


def phase_serving_surface(model, pipe, prompts, runs, card):
    """The server as users run it, on the 40-layer bf16 pipe of phase 4
    (paged pool, 8 slots): the stream route, a reconnect, the journal,
    resume, /metrics against /stats, a flight-recorder bundle, the drain,
    and the simple engine. Returns the K3 launches of its runs."""
    import torch
    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             SimpleEngine,
                                             build_stdlib_server,
                                             create_continuous_engine,
                                             drain)
    from fengshen_tpu_torch.observability import FlightRecorder
    from fengshen_tpu_torch.ops.kernels import (get_entry,
                                                reset_launch_counts)
    entry = get_entry("decode_attention")
    layers = model.config.num_hidden_layers
    want = runs["paged"]
    texts = [" ".join(map(str, p)) for p in prompts]
    checks, failures = {}, []

    def check(name, ok, **detail):
        checks[name] = bool(ok)
        if not ok:
            failures.append(f"{name}: {detail}")

    with tempfile.TemporaryDirectory() as tmp:
        recorder = FlightRecorder(dump_dir=tmp)
        engine = create_continuous_engine(
            pipe, {"num_slots": 8, "kv_layout": "paged", "max_queue": 16},
            recorder=recorder)
        engine.warmup()
        engine.start()
        ready, draining = threading.Event(), threading.Event()
        ready.set()
        server = build_stdlib_server(
            ServerConfig(host="127.0.0.1", port=0, engine="continuous",
                         dump_dir=tmp), PipelineConfig(), pipeline=pipe,
            engine=engine, ready=ready, recorder=recorder,
            draining=draining)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            before = engine.stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
                streams = list(pool.map(lambda i: sse_post(port, {
                    "input_text": texts[i], "max_new_tokens": NEW_TOKENS,
                    "request_id": f"stream-{i}"}), range(len(texts))))
            stream_s = time.perf_counter() - t0
            ttft = [s[2] for s in streams]
            check("stream_equals_blocking",
                  [s[0] for s in streams] == want,
                  parted=[near_tie(model, p, w, s[0]) for p, w, s in
                          zip(prompts, want, streams)])
            check("stream_done_events", all(
                s[1][-1]["event"] == "done" and
                s[1][-1]["id"] == NEW_TOKENS for s in streams))
            # a client that drops after 10 tokens, reads the journal,
            # and reconnects with Last-Event-ID 9
            head, _, _ = sse_post(port, {"input_text": texts[3],
                                         "max_new_tokens": NEW_TOKENS,
                                         "request_id": "reconnect"},
                                  limit=10)
            code, mid = http_json(port, "/partial/reconnect")
            tail, frames, _ = sse_post(port, {"request_id": "reconnect"},
                                       headers={"Last-Event-ID": "9"})
            check("reconnect_gapless", head + tail == want[3] and
                  frames[0]["id"] == 10, head=len(head), tail=len(tail))
            check("partial_mid_stream", code == 200 and
                  mid["tokens"] == want[3][:len(mid["tokens"])] and
                  len(mid["tokens"]) >= 10, partial=mid)
            code, done = http_json(port, "/partial/reconnect")
            check("partial_equals_committed", code == 200 and
                  done["tokens"] == head + tail and
                  done["state"] == "finished" and
                  done["result"] == " ".join(map(str, want[3])))
            # resume prompts 1 and 5 from their first 12 tokens
            resumed = {}
            for i in (1, 5):
                code, body = http_json(port, "/api/text_generation", {
                    "input_text": texts[i], "max_new_tokens": NEW_TOKENS,
                    "resume_tokens": want[i][:12],
                    "request_id": f"resume-{i}"})
                got = [int(t) for t in body["result"].split()]
                resumed[i] = near_tie(model, prompts[i], want[i], got)
                if code != 200 or (resumed[i] is not None and
                                   not resumed[i]["ok"]):
                    failures.append(f"resume {i}: {code} {resumed[i]}")
            checks["resume_tail_identical"] = all(
                v is None for v in resumed.values())
            checks["resume_within_near_tie_bar"] = all(
                v is None or v["ok"] for v in resumed.values())
            stats = engine.stats()
            _, text = http_json(port, "/metrics")
            samples = {}
            for line in text.splitlines():
                if line and not line.startswith("#"):
                    key, _, value = line.rpartition(" ")
                    samples[key] = float(value)
            agree = {
                "admitted": "fstpu_serving_admitted_total",
                "completed": "fstpu_serving_completed_total",
                "decode_ticks": "fstpu_serving_decode_ticks_total",
                "decode_tokens": "fstpu_serving_decode_tokens_total",
                "rejected_duplicate":
                    "fstpu_serving_rejected_duplicate_total"}
            check("metrics_agree_with_stats", all(
                samples.get(m) == stats[k] for k, m in agree.items()),
                  stats={k: stats[k] for k in agree},
                  metrics={m: samples.get(m) for m in agree.values()})
            code, dumped = http_json(port, "/debug/dump", {})
            bundle = Path(dumped["bundle"]) if code == 200 else None
            check("debug_dump_bundle", bundle is not None and
                  (bundle / "engine.json").is_file() and
                  (bundle / "manifest.json").is_file(), code=code)
            code, debug = http_json(port, "/debug/requests/resume-1")
            check("debug_timeline", code == 200 and
                  debug["events"][0]["event"] == "enqueued" and
                  debug["events"][-1]["event"] == "finished")
            # the drain: 8 requests in flight, then the handler's body
            t_drain = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
                base = sum(engine.stats()["prefills_per_bucket"].values())
                inflight = [pool.submit(post, port, t) for t in texts]
                # every request prefilled into a lane (none queued)
                deadline = time.monotonic() + 120
                while sum(engine.stats()["prefills_per_bucket"].values()) \
                        < base + len(texts) and time.monotonic() < deadline:
                    time.sleep(0.005)
                busy = engine.stats()["slots_active"]
                waiter = drain(server, draining, engine=engine,
                               recorder=recorder)
                refused = http_json(port, "/api/text_generation",
                                    {"input_text": texts[0]})
                health = http_json(port, "/healthz")
                results = [f.result() for f in inflight]
            waiter.join(timeout=120)
            thread.join(timeout=30)
            drain_s = time.perf_counter() - t_drain
            drained = [[int(t) for t in r[1]["result"].split()]
                       if r[0] == 200 else [] for r in results]
            check("drain_in_flight_finish", busy > 0 and all(
                r[0] == 200 and d == w
                for r, d, w in zip(results, drained, want)),
                  busy=busy, codes=[r[0] for r in results],
                  errors=[r[1] for r in results if r[0] != 200],
                  parted=[near_tie(model, p, w, d) for p, w, d in
                          zip(prompts, want, drained)])
            check("drain_refuses_new_work", refused == (503, {
                "error": "replica draining", "reason": "draining"}))
            check("drain_healthz", health[0] == 503 and
                  health[1]["reason"] == "draining")
            check("drain_shuts_down", not thread.is_alive() and
                  not waiter.is_alive() and any(
                      p.name.endswith("sigterm_drain")
                      for p in Path(tmp).iterdir()))
            torch.cuda.synchronize()
            after = engine.stats()
            launches, dense = entry.launches, entry.dense_calls
            variants = dict(entry.variants)
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
    ticks = after["decode_ticks"] - before["decode_ticks"]
    prefills = sum(after["prefills_per_bucket"].values()) - \
        sum(before["prefills_per_bucket"].values())
    check("k3_launches_pinned", variants == {"s1": layers * ticks} and
          launches == layers * ticks and dense == layers * prefills,
          variants=variants, ticks=ticks, dense=dense, prefills=prefills)
    # the simple engine, over a prompt of 64 (one bucket, no padding)
    simple = SimpleEngine(pipe)
    simple.warmup()
    simple_server = build_stdlib_server(
        ServerConfig(host="127.0.0.1", port=0, engine="simple"),
        PipelineConfig(), pipeline=pipe, engine=simple)
    sport = simple_server.server_address[1]
    sthread = threading.Thread(target=simple_server.serve_forever,
                               daemon=True)
    sthread.start()
    i64 = PROMPT_LENGTHS.index(64)
    try:
        reset_launch_counts()
        code, body = http_json(sport, "/api/text_generation", {
            "input_text": texts[i64], "max_new_tokens": NEW_TOKENS})
        torch.cuda.synchronize()
        simple_launches, simple_variants = entry.launches, \
            dict(entry.variants)
        simple_dense = entry.dense_calls
    finally:
        simple_server.shutdown()
        simple_server.server_close()
    got = [int(t) for t in body["result"].split()] if code == 200 else []
    parted = near_tie(model, prompts[i64], want[i64], got)
    checks["simple_equals_continuous"] = parted is None
    check("simple_within_near_tie_bar", parted is None or parted["ok"],
          parted=parted)
    check("simple_k3_launches", simple_variants == {
        "s1": layers * (NEW_TOKENS - 1)} and simple_dense == layers,
          variants=simple_variants, dense=simple_dense)
    say("serving_surface", card=card, checks=checks,
        ttft_first_token_event_s=[round(t, 4) for t in ttft],
        ttft_median_s=sorted(ttft)[len(ttft) // 2],
        streams_wall_s=stream_s, drain_wall_s=drain_s,
        lanes_busy_at_drain=busy,
        resume_parted=resumed, simple_parted=parted,
        decode_ticks=ticks, prefills=prefills, k3_variants=variants,
        simple_k3_variants=simple_variants,
        metrics_samples=len(samples))
    del engine, server, simple, simple_server
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("serving surface: " + "; ".join(failures))
    return launches + simple_launches


# -- phase 4d -----------------------------------------------------------

#: checkpoint round trip (phase 4d): layers kept at Ziya width (40
#: would write 26 GB per run)
CKPT_LAYERS = 2


def write_safetensors(path: Path, tensors: dict) -> int:
    """A safetensors file (an 8-byte little-endian header length, the
    JSON header of ``dtype``, ``shape`` and ``data_offsets``, then the
    bytes), written tensor by tensor from the card. Returns bytes."""
    import struct
    import torch
    dtypes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": dtypes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(
                torch.uint8).numpy().tobytes())
    return 8 + len(head) + offset


def phase_checkpoint(prompts, card):
    """A 2-layer checkpoint at Ziya width (bf16, untied head, ~2.1 GB)
    written as two safetensors shards, loaded with
    ``Pipeline(model=dir, tokenizer=IdTokenizer(), device="cuda")``,
    every parameter held bitwise to the model it was written from, then
    both served on the 8 prompts through K3 with equal tokens. Returns
    the K3 launches of the loaded model's run."""
    import torch
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    cfg = dataclasses.replace(LlamaConfig.from_pretrained(str(ZIYA_CONFIG)),
                              num_hidden_layers=CKPT_LAYERS,
                              param_dtype="bfloat16", dtype="bfloat16",
                              attention_impl="dense", scan_layers=False,
                              gradient_checkpointing=False)
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    state = model.state_dict()
    names = sorted(state)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg.save_pretrained(tmp)
        written = sum(write_safetensors(
            Path(tmp) / f"model-{i + 1:05d}-of-00002.safetensors",
            {k: state[k] for k in names[i::2]}) for i in range(2))
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = Pipeline(model=tmp, tokenizer=IdTokenizer(),
                          max_new_tokens=NEW_TOKENS, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    got = loaded.module.state_dict()
    unequal = [k for k in names if got[k].dtype != state[k].dtype or
               not torch.equal(got[k], state[k])]
    entry = get_entry("decode_attention")
    pipe = Pipeline(module=model, tokenizer=IdTokenizer(),
                    max_new_tokens=NEW_TOKENS, device="cuda")
    want, _ = serve_run(pipe, "paged", prompts, entry)
    served, launches = serve_run(loaded, "paged", prompts, entry)
    say("checkpoint", card=card, layers=CKPT_LAYERS,
        hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        tensors=len(names), gib_written=written / 2**30,
        gib_read=written / 2**30, write_s=write_s, load_s=load_s,
        load_gib_per_s=written / 2**30 / load_s,
        params_bitwise_equal=not unequal,
        served_equal=served == want, k3_launches=launches)
    if unequal or served != want or loaded.module.lm_head is None:
        raise AssertionError(f"checkpoint round trip: {len(unequal)} "
                             f"parameters differ ({unequal[:4]}), served "
                             f"equal {served == want}")
    del model, loaded, pipe, state, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 6 ------------------------------------------------------------

def phase_profile(pipe, prompts, ticks: int = 8, kv_dtype: str = "fp32",
                  layout: str = "paged", engine_args=None):
    """Where a decode tick's time goes: an engine (``layout``, ``kv_dtype``
    pool, ``engine_args``: a speculative tick when they name a
    ``spec_mode``) with all 8 lanes decoding, ``ticks`` ticks under
    ``torch.profiler``. Reports wall time
    per tick, device-busy time per tick (sum of kernel self times; one
    stream, so kernels do not overlap), the device's idle share, and the
    kernels that take most device time. Run after the timed phases, so
    its overhead touches no reported number."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fengshen_tpu_torch.api.main import create_continuous_engine
    engine_args = dict(engine_args or {})
    engine = create_continuous_engine(
        pipe, {"num_slots": 8, "kv_layout": layout, "kv_dtype": kv_dtype,
               **engine_args})
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
    k3_ms = sum(us for name, us in kernels.items()
                if "decode_split_kernel" in name) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    say("profile", layout=layout, kv_dtype=kv_dtype,
        engine_args=engine_args, lanes=8, ticks=ticks,
        wall_ms_per_tick=wall * 1e3 / ticks,
        device_busy_ms_per_tick=(busy_ms / ticks if kernels else
                                 "not measured: no device events"),
        k3_ms_per_tick=(k3_ms / ticks if kernels else "not measured"),
        k3_share_of_busy=(k3_ms / busy_ms if kernels else "not measured"),
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
    entry = get_entry("decode_attention")
    served, launches = serve_run(pipe, "paged", prompts, entry)
    phase_teacher_forced(model, prompts, {"paged": served},
                         margin=FP32_MARGIN, phase="fp32_bar")
    # this bar's own K3 launches; the kernels line counts the main path's
    say("fp32_bar", layers=FP32_LAYERS, decode_attention_launches=launches)
    # the same model from an int8 pool: K3's int8 branch dequantizing
    # through fp32, held to the fp32 pool's tokens
    served8, _ = serve_run(pipe, "paged", prompts, entry, kv_dtype="int8")
    int8_bar(model, prompts, {"paged": served}, {"paged": served8},
             "fp32_int8_bar")
    int8_rescoring_bar(model, pipe, prompts, {"paged": served8},
                       INT8_FP32_MARGIN, "fp32_int8_rescore")
    full_acceptance(model, pipe, prompts, entry)
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()


def full_acceptance(model, pipe, prompts, entry):
    """The fp32 model with layers 2 and 3 reduced to the identity (their
    o_proj and down_proj zeroed, so the residual stream passes through
    them unchanged): its 2-layer self-draft then computes the target's
    logits, so a greedy self_draft engine (fp32 slot pool) must accept
    every draft (acceptance 1.0 over FULL_ACCEPT_NEW tokens, which fill
    whole windows) and serve the non-spec engine's tokens. They may part
    only at a near-tie: at a sequence's first disagreement the cacheless
    forward's top-2 gap must be within FP32_MARGIN."""
    import torch
    with torch.no_grad():
        for layer in model.model.layers[SPEC_DRAFT_LAYERS:]:
            layer.self_attn.o_proj.weight.zero_()
            layer.mlp.down_proj.weight.zero_()
    plain, _ = serve_run(pipe, "slot", prompts, entry,
                         max_new=FULL_ACCEPT_NEW)
    stats = {}
    spec, _ = serve_run(pipe, "slot", prompts, entry,
                        engine_args={"spec_mode": "self_draft",
                                     "spec_gamma": SPEC_GAMMA,
                                     "spec_draft_layers": SPEC_DRAFT_LAYERS},
                        max_new=FULL_ACCEPT_NEW, stats_out=stats)
    parted = []
    with torch.no_grad():
        for prompt, want, got in zip(prompts, plain, spec):
            t = next((i for i, (a, b) in enumerate(zip(want, got))
                      if a != b), None)
            if t is not None:
                top2 = rescored(model, prompt, want)[0][t].topk(2).values
                parted.append({"position": t,
                               "top2_gap": float(top2[0] - top2[1])})
    rate = stats["spec_acceptance_rate"]
    say("fp32_full_acceptance", acceptance_rate=rate,
        identical_sequences=len(prompts) - len(parted),
        sequences=len(prompts), first_disagreements=parted,
        margin=FP32_MARGIN, ticks=stats["ticks"],
        variants=stats["variants"])
    if rate != 1.0 or any(p["top2_gap"] > FP32_MARGIN for p in parted):
        raise AssertionError(
            f"fp32 self_draft over identity layers: acceptance {rate}, "
            f"disagreements {parted} (margin {FP32_MARGIN})")


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


def no_checkpoints(path: Path) -> list:
    """Checkpoint flags for a run that saves and restores nothing: its
    own empty directory, and an interval past the run's end (the
    reference's ``main`` always adds the callback, which saves at the
    end of a fit without an interval)."""
    return ["--save_ckpt_path", str(path), "--load_ckpt_path", str(path),
            "--every_n_train_steps", str(10 ** 9)]


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
    from fengshen_tpu_torch.ops.kernels import (get_entry,
                                                reset_launch_counts)
    from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
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
        workdir / "runs", "--device", "cuda",
        *no_checkpoints(workdir / "ckpt"))]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = finetune_ziya_llama.main(argv, tokenizer=IdTokenizer())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: get_entry(name).launches for name in K1_NAMES}
    variants = {name: dict(get_entry(name).variants) for name in K1_NAMES}
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
    if variants != {n: {"tensor_core": c} for n, c in want.items()}:
        raise AssertionError(f"training: bf16 compute must launch only the "
                             f"tensor-core K1, got {variants}")

    # step 1 again on fresh weights from the same seed and the same
    # batch with the plain attention (the dispatch's plain branch); then,
    # in fp32 compute, where rounding leaves K1's gradients distinct from
    # a fault's, with the plain attention, with K1, and with faults
    # planted in K1's backward
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.llama import LlamaConfig
    from fengshen_tpu_torch.ops import kernels
    from fengshen_tpu_torch.ops.kernels import flash_attention as seam
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
        launches=launches, variants=variants, plain_step1_loss=ref_loss,
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


# -- phase 3, K2 -----------------------------------------------------------

def ce_bounds(n_tok, hid, vocab, elt):
    """Least time of each K2 kernel on these inputs: bytes (each input
    read once, each output written once) over the HBM rate, against the
    flops over the bf16 tensor-core rate; the larger bounds it. fwd: the
    scores (2 T V H). dx: the scores again and d K^T (4 T V H), from x,
    K, labels, lse and the two cotangents. dK: x^T d (2 T V H) from x and
    the d that K2-dx leaves in x's dtype (this design's dK kernel does
    not recompute the scores)."""
    xb, wb, rows = n_tok * hid * elt, hid * vocab * elt, n_tok * 4
    pass_flops = 2.0 * n_tok * vocab * hid
    work = {"fwd": (xb + wb + rows + 3 * rows, pass_flops),
            "dx": (xb + wb + 4 * rows + xb, 2 * pass_flops),
            "dk": (xb + n_tok * vocab * elt + wb, pass_flops)}
    out = {}
    for name, (moved, flops) in work.items():
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def ce_top2_gap(xf, wf, chunk=4096):
    """The gap between each token's two largest fp32 scores."""
    import torch
    gaps = []
    for t0 in range(0, xf.shape[0], chunk):
        top = (xf[t0:t0 + chunk] @ wf).topk(2, -1).values
        gaps.append(top[:, 0] - top[:, 1])
    return torch.cat(gaps)


def ce_case(gen):
    """K2's operands at the long-context shape: x like final-norm hidden
    states (unit rms), the head at the config's initializer range 0.02,
    bf16; labels uniform over the vocab, about 3 % ignored (-100) and 10 %
    set to the fp32 argmax, so that n_correct carries signal."""
    import torch
    from fengshen_tpu_torch.ops.kernels.fused_ce import torch_ce_token_stats
    x = torch.randn(CE_TOKENS, CE_HIDDEN, generator=gen,
                    device="cuda").bfloat16()
    w = (torch.randn(CE_HIDDEN, CE_VOCAB, generator=gen, device="cuda") *
         0.02).bfloat16()
    labels = torch.randint(0, CE_VOCAB, (CE_TOKENS,), generator=gen,
                           device="cuda", dtype=torch.int32)
    u = torch.rand(CE_TOKENS, generator=gen, device="cuda")
    amax = torch_ce_token_stats(x.float(), w.float(), labels)[2]
    labels = torch.where(u < 0.10, amax, labels)
    labels = torch.where(u > 0.97, -100, labels).int().contiguous()
    return x, w, labels


def time_ce_backward(x, w, labels, lse, c_lse, c_gold):
    """Milliseconds of all K2-dx and of all K2-dK launches of one
    backward (CUDA events around each launch)."""
    import torch
    from fengshen_tpu_torch.ops.kernels import fused_ce as k2
    n_tok = x.shape[0]
    d = torch.empty(min(k2.BWD_CHUNK, n_tok), w.shape[1], dtype=x.dtype,
                    device="cuda")
    total = torch.empty(w.shape, dtype=torch.float32, device="cuda")
    dx, dk = torch.empty_like(x), torch.empty_like(w)
    events = []
    for i, t0 in enumerate(range(0, n_tok, k2.BWD_CHUNK)):
        sl = slice(t0, min(t0 + k2.BWD_CHUNK, n_tok))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        k2.cuda_ce_bwd_dx(x[sl], w, labels[sl], lse[sl], c_lse[sl],
                          c_gold[sl], d, dx[sl])
        ev[1].record()
        k2.cuda_ce_bwd_dk(x[sl], d, labels[sl], c_gold[sl], total,
                          dk if sl.stop == n_tok else None, first=i == 0)
        ev[2].record()
        events.append(ev)
    torch.cuda.synchronize()
    return (sum(e[0].elapsed_time(e[1]) for e in events),
            sum(e[1].elapsed_time(e[2]) for e in events))


def phase_ce_kernels():
    """K2 against its plain version at the long-context shape (T =
    32767, H = 4096, V = 32000, bf16). The plain versions run in fp32 on
    the same bf16 inputs (the kernels keep fp32 scores; the plain
    version run in bf16 rounds them); the backward's take the kernel's
    lse and the loss's cotangents. The check is also shown to reject
    planted faults: the last vocab tile left out of the forward stats of
    one token in 97 and of every token labelled in that tile, and one
    128-token tile left out of dK. Times of
    the kernels, the plain versions on the kernels' (bf16) inputs and
    torch's materialised-logits CE (forward, and its autograd backward,
    which gives dx and dK in one call)."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels import fused_ce as k2
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, w, labels = ce_case(gen)
    valid = labels != -100
    n_valid = int(valid.sum())
    c_lse = valid.float() / n_valid
    c_gold = -c_lse
    # the memory the kernels add above their inputs: their outputs, the
    # fp32 d workspace and the fp32 dK sum; [T, V] fp32 logits would be
    # 4.2 GB alone
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lse, gold, amax = k2.cuda_ce_fwd(x, w, labels)
    dx, dk = k2.kernel_ce_backward(x, w, labels, lse, c_lse, c_gold)
    torch.cuda.synchronize()
    added_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    loss, k_valid, k_correct = k2.kernel_fused_ce(x[None], w, labels[None])
    torch.cuda.synchronize()
    xf, wf = x.float(), w.float()
    ref_lse, ref_gold, ref_amax = k2.torch_ce_token_stats(xf, wf, labels)
    ref_dx = k2.torch_ce_bwd_dx(xf, wf, labels, lse, c_lse, c_gold)
    ref_dk = k2.torch_ce_bwd_dk(xf, wf, labels, lse, c_lse, c_gold)
    failures, report = [], {"kernels_added_gib": added_gib}
    for name, got in (("lse", lse), ("gold", gold), ("dx", dx), ("dk", dk)):
        if not torch.isfinite(got.float()).all():
            failures.append(f"K2 {name}: non-finite")
    stat_err = {n: (got - want).abs().max().item() for n, got, want in (
        ("lse", lse, ref_lse), ("gold", gold, ref_gold))}
    report["stat_max_abs_err"] = stat_err
    if max(stat_err.values()) > CE_STAT_ATOL:
        failures.append(f"K2 forward stats: {stat_err}")
    # argmax: every disagreement must be a near-tie
    gap = ce_top2_gap(xf, wf)
    wrong = amax != ref_amax
    report["argmax_disagreements"] = int(wrong.sum())
    report["argmax_worst_gap"] = gap[wrong].max().item() if wrong.any() \
        else 0.0
    if wrong.any() and report["argmax_worst_gap"] >= CE_ARGMAX_MARGIN:
        failures.append(f"K2 argmax: a disagreement at a top-2 gap of "
                        f"{report['argmax_worst_gap']}")
    ref_correct = int(((ref_amax == labels) & valid).sum())
    near = int((wrong & valid & ((labels == amax) |
                                 (labels == ref_amax))).sum())
    report.update(n_valid=int(k_valid), n_correct=int(k_correct),
                  plain_n_correct=ref_correct, near_tie_label_hits=near)
    if int(k_valid) != n_valid or abs(int(k_correct) - ref_correct) > near:
        failures.append(f"K2 counts: n_valid {int(k_valid)} / {n_valid}, "
                        f"n_correct {int(k_correct)} / {ref_correct}")
    ref_loss = (((ref_lse - ref_gold) * valid).sum() / n_valid).item()
    report["loss"], report["plain_loss"] = loss.item(), ref_loss
    # gradients: element-wise against the plain version on the kernel's
    # lse; relative L2 against autograd through fp32 logits
    xa, wa = (t.clone().requires_grad_(True) for t in (xf, wf))
    auto = torch.autograd.grad(F.cross_entropy(
        xa @ wa, labels.long(), ignore_index=-100), (xa, wa))
    del xa, wa
    for name, got, want, ref in (("dx", dx, ref_dx, auto[0]),
                                 ("dk", dk, ref_dk, auto[1])):
        reading = k1_reading(got, want.float())
        reading["rel_l2_autograd"] = ((got.float() - ref).norm() /
                                      ref.norm()).item()
        report[name] = reading
        if reading["worst"] > 1.0 or reading["rel_l2_autograd"] > K1_L2_TOL:
            failures.append(f"K2 {name}: {reading}")
    # planted faults
    planted = {}
    # one token in 97, and every token whose label lies in the last tile
    rows = torch.arange(CE_TOKENS, device="cuda")
    rows = rows[(rows % 97 == 0) | (labels >= CE_VOCAB - CE_TILE)]
    cut = wf[:, :CE_VOCAB - CE_TILE]
    s_cut = xf[rows] @ cut
    lab = labels[rows].long()
    inside = (lab >= 0) & (lab < cut.shape[1])
    faults = {"lse": torch.logsumexp(s_cut, -1),
              "gold": torch.where(inside, s_cut.gather(
                  1, lab.clamp(0, cut.shape[1] - 1)[:, None])[:, 0], 0.0)}
    for name, got, want in (("lse", lse, ref_lse), ("gold", gold, ref_gold)):
        mutant = got.clone()
        mutant[rows] = faults[name]
        planted[f"{name}_last_vocab_tile"] = \
            (mutant - want).abs().max().item() / CE_STAT_ATOL
    t0 = CE_TOKENS // 2
    tile = slice(t0, t0 + CE_TILE)
    d_tile = k2._plain_d(xf[tile], wf, labels[tile], lse[tile], c_lse[tile],
                         c_gold[tile])
    mutant = (dk.float() - xf[tile].T @ d_tile).to(dk.dtype)
    planted["dk_token_tile"] = k1_reading(mutant, ref_dk.float())
    planted["dk_token_tile"]["rel_l2_autograd"] = (
        (mutant.float() - auto[1]).norm() / auto[1].norm()).item()
    del mutant, d_tile, s_cut, auto, ref_dx, ref_dk
    for key, reading in planted.items():
        worst = reading if isinstance(reading, float) else reading["worst"]
        if worst <= 1.0:
            failures.append(f"K2 planted {key}: the check gave {reading}")
    report["planted"] = planted
    # times: the kernels, the plain versions on the kernels' inputs, and
    # torch's materialised-logits CE
    ms = {"fused_ce_fwd": cuda_ms(lambda: k2.cuda_ce_fwd(x, w, labels), 2)}
    runs = [time_ce_backward(x, w, labels, lse, c_lse, c_gold)
            for _ in range(2)]
    ms["fused_ce_bwd_dx"] = sum(r[0] for r in runs) / len(runs)
    ms["fused_ce_bwd_dk"] = sum(r[1] for r in runs) / len(runs)
    plain_ms = {
        "fused_ce_fwd": cuda_ms(
            lambda: k2.torch_ce_token_stats(x, w, labels), 2),
        "fused_ce_bwd_dx": cuda_ms(lambda: k2.torch_ce_bwd_dx(
            x, w, labels, lse, c_lse, c_gold), 2),
        "fused_ce_bwd_dk": cuda_ms(lambda: k2.torch_ce_bwd_dk(
            x, w, labels, lse, c_lse, c_gold), 2)}
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    lab64 = labels.long()

    def library_loss():
        return F.cross_entropy(F.linear(xl, wl.T).float(), lab64,
                               ignore_index=-100)

    lib_fwd = cuda_ms(library_loss, 3)
    out = library_loss()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (xl, wl),
                                                  retain_graph=True), 3)
    del out, xl, wl
    bounds = ce_bounds(CE_TOKENS, CE_HIDDEN, CE_VOCAB, x.element_size())
    rows_out = {}
    for name, key, lib, err in (
            ("fused_ce_fwd", "fwd", lib_fwd, max(stat_err.values())),
            ("fused_ce_bwd_dx", "dx", lib_bwd, report["dx"]["max_abs_err"]),
            ("fused_ce_bwd_dk", "dk", lib_bwd, report["dk"]["max_abs_err"])):
        rows_out[name] = dict(ms=ms[name], plain_ms=plain_ms[name],
                              library_ms=lib, bound_ms=bounds[key][0],
                              bound_by=bounds[key][1], max_abs_err=err)
    say("kernel", name="fused_ce", tokens=CE_TOKENS, hidden=CE_HIDDEN,
        vocab=CE_VOCAB, dtype="bfloat16", bwd_chunk=k2.BWD_CHUNK,
        stat_atol=CE_STAT_ATOL, rtol=K1_RTOL, l2_tol=K1_L2_TOL,
        argmax_margin=CE_ARGMAX_MARGIN, **report, times_ms=ms,
        plain_ms=plain_ms, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
        bound_ms={k: b[0] for k, b in bounds.items()},
        bound_by={k: b[1] for k, b in bounds.items()},
        fraction_of_bound={n: r["bound_ms"] / r["ms"]
                           for n, r in rows_out.items()})
    del x, w, labels, xf, wf, lse, gold, amax, dx, dk, ref_lse, ref_gold
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return rows_out


# -- phase 3, K4 ------------------------------------------------------------

def bs_bounds(layout, batch, heads, seq, dim, block, elt):
    """Least time of each K4 kernel on these inputs (Sq = Sk = seq): bytes
    (each input read once, each output written once) over the HBM rate,
    against the flops of the present blocks over the bf16 tensor-core
    rate; the larger bounds it. One product over the present blocks is
    2 block^2 dim flops per block and head: fwd 2 (Q K^T, P V), dK/dV 4
    (Q K^T, dO V^T, P^T dO, dS^T Q), dQ 3 (Q K^T, dO V^T, dS K)."""
    product = 2.0 * block * block * dim * int(layout.sum()) * batch * heads
    io = batch * seq * heads * dim * elt
    rows = batch * heads * seq * 4
    work = {"fwd": (4 * io + rows, 2 * product),
            "dkv": (6 * io + 2 * rows, 4 * product),
            "dq": (5 * io + 2 * rows, 3 * product)}
    out = {}
    for name, (moved, flops) in work.items():
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def bs_check(name, got, want, failures, report):
    """k1_reading of a K4 result against its fp32 plain version, and its
    relative L2; failures collect what breaks either bar."""
    import torch
    reading = k1_reading(got, want)
    reading["rel_l2"] = ((got.float() - want).norm() /
                         want.norm().clamp(min=1e-30)).item()
    report[name] = reading
    if not torch.isfinite(got.float()).all() or reading["worst"] > 1.0 or \
            reading["rel_l2"] > K1_L2_TOL:
        failures.append(f"K4 {name}: {reading}")


def bs_kernels(q, k, v, g, layout, block):
    """The three K4 kernels on one input: out, lse, delta, dq, dk, dv."""
    from fengshen_tpu_torch.ops.kernels import block_sparse_attention as k4
    out, lse = k4.cuda_bs_fwd(q, k, v, layout, block)
    delta = k4.attention_delta(out, g)
    dk, dv = k4.cuda_bs_bwd_dkv(q, k, v, g, lse, delta, layout, block)
    dq = k4.cuda_bs_bwd_dq(q, k, v, g, lse, delta, layout, block)
    return out, lse, delta, dq, dk, dv


def bs_case(seq, heads, gen):
    """q, k, v and a cotangent [1, seq, heads, BS_DIM], bf16."""
    import torch
    def rnd():
        return torch.randn(1, seq, heads, BS_DIM, generator=gen,
                           device="cuda").bfloat16()
    return rnd(), rnd(), rnd(), rnd()


def phase_block_sparse():
    """The block-sparse path and K4. At Ziya's attention width (B = 1,
    S = BS_SEQ, 40 heads of 128, bf16, 128-token blocks, the BigBird
    layout): ``dot_product_attention(impl="sparse")`` forward and its
    backward by autograd, counts set to 0 just before and read just
    after (one launch of each kernel, no dense call). Then each kernel on
    the same inputs (they must give the path's results exactly) against
    its plain version run in fp32 on the same bf16 inputs (the backward
    kernels' on the forward kernel's lse and delta): out, dq, dk and dv
    within k1_reading's element limit and K1_L2_TOL relative L2, lse
    within K1_LSE_ATOL. A small layout with an empty query block and an
    unread key block is checked the same way. Planted faults must be
    rejected: one present block dropped from the forward's block list,
    and one query block's contribution dropped from dK/dV. Times of the
    kernels (on the layout's block lists built once, as the path does,
    and with each call building them anew), of the path's forward and
    backward, of the plain versions on the kernels' bf16 inputs, and of
    SDPA with the layout expanded into a boolean mask (forward, and its
    backward by autograd)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops import masks
    from fengshen_tpu_torch.ops.attention import dot_product_attention
    from fengshen_tpu_torch.ops.kernels import (get_entry,
                                                reset_launch_counts)
    from fengshen_tpu_torch.ops.kernels import block_sparse_attention as k4
    gen = torch.Generator(device="cuda").manual_seed(7)
    failures, report = [], {}
    layout = masks.bigbird_block_layout(BS_SEQ, BS_BLOCK, BS_RANDOM,
                                        BS_GLOBAL, BS_WINDOW, seed=0)
    q, k, v, g = bs_case(BS_SEQ, BS_HEADS, gen)

    # the path
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = dot_product_attention(qg, kg, vg, impl="sparse",
                                sparse_layout=layout,
                                sparse_block_size=BS_BLOCK)
    out.backward(g)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {n: get_entry(n).launches for n in K4_NAMES}
    variants = {n: dict(get_entry(n).variants) for n in K4_NAMES}
    dense_calls = get_entry(K4_NAMES[0]).dense_calls
    if launches != {n: 1 for n in K4_NAMES} or dense_calls != 0 or \
            variants != {n: {"tensor_core": 1} for n in K4_NAMES}:
        failures.append(f"K4 path: launches {launches}, variants "
                        f"{variants}, dense calls {dense_calls}; want one "
                        "tensor-core launch each and 0")

    # the kernels against their plain versions
    k_out, lse, delta, dq, dk, dv = bs_kernels(q, k, v, g, layout, BS_BLOCK)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in (
        (out, k_out), (qg.grad, dq), (kg.grad, dk), (vg.grad, dv)))
    if not same:
        failures.append("K4 path: the autograd path's results differ from "
                        "the kernels' on the same inputs")
    del qg, kg, vg, out
    f32 = [t.float() for t in (q, k, v, g)]
    ref_out, ref_lse = k4.torch_bs_fwd(*f32[:3], layout, BS_BLOCK)
    ref_dq, ref_dk, ref_dv = k4.torch_bs_bwd(*f32, lse, delta, layout,
                                             BS_BLOCK)
    for name, got, want in (("out", k_out, ref_out), ("dq", dq, ref_dq),
                            ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        bs_check(name, got, want, failures, report)
    lse_err = (lse - ref_lse).abs().max().item()
    report["lse"] = {"max_abs_err": lse_err}
    if lse_err > K1_LSE_ATOL:
        failures.append(f"K4 lse: max abs err {lse_err}")

    # planted faults
    qb, kb = BS_FAULT_BLOCK
    dropped = layout.copy()
    if not dropped[qb, kb] or dropped[qb].sum() < 2:
        raise AssertionError(f"K4: block {BS_FAULT_BLOCK} is not a present "
                             "block of a row with others")
    dropped[qb, kb] = False
    planted = {"fwd_block_dropped": k1_reading(
        k4.cuda_bs_fwd(q, k, v, dropped, BS_BLOCK)[0], ref_out)}
    mut_dk, mut_dv = k4.cuda_bs_bwd_dkv(q, k, v, g, lse, delta, dropped,
                                        BS_BLOCK)
    planted["dkv_query_block_dropped_dk"] = k1_reading(mut_dk, ref_dk)
    planted["dkv_query_block_dropped_dv"] = k1_reading(mut_dv, ref_dv)
    torch.cuda.synchronize()
    del mut_dk, mut_dv
    for key, reading in planted.items():
        if reading["worst"] <= 1.0:
            failures.append(f"K4 planted {key}: the check gave {reading}")
    report["planted"] = planted

    # times: the kernels on the layout's block lists built once, as the
    # path builds them once per forward; and each call building them
    # anew (host work and small copies inside the timed window)
    csr = k4.block_csr(layout, q.device)
    kernels = {
        "block_sparse_attention_fwd": lambda c=csr: k4.cuda_bs_fwd(
            q, k, v, layout, BS_BLOCK, c),
        "block_sparse_attention_bwd_dkv": lambda c=csr: k4.cuda_bs_bwd_dkv(
            q, k, v, g, lse, delta, layout, BS_BLOCK, c),
        "block_sparse_attention_bwd_dq": lambda c=csr: k4.cuda_bs_bwd_dq(
            q, k, v, g, lse, delta, layout, BS_BLOCK, c)}
    plains = {
        "block_sparse_attention_fwd": lambda: k4.torch_bs_fwd(
            q, k, v, layout, BS_BLOCK),
        "block_sparse_attention_bwd_dkv": lambda: k4.torch_bs_bwd(
            q, k, v, g, lse, delta, layout, BS_BLOCK),
        "block_sparse_attention_bwd_dq": lambda: k4.torch_bs_bwd(
            q, k, v, g, lse, delta, layout, BS_BLOCK)}
    clocks_before = clocks()
    ms = {n: cuda_ms(fn, 20) for n, fn in kernels.items()}
    clocks_after = clocks()
    lists_per_call_ms = {n: cuda_ms(lambda f=fn: f(None), 20)
                         for n, fn in kernels.items()}
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def path():
        o = dot_product_attention(qg, kg, vg, impl="sparse",
                                  sparse_layout=layout,
                                  sparse_block_size=BS_BLOCK)
        return torch.autograd.grad(o, (qg, kg, vg), g)

    path_ms = cuda_ms(path, 5)
    del qg, kg, vg
    plain_ms = {n: cuda_ms(fn, 2) for n, fn in plains.items()}
    mask = torch.from_numpy(np.kron(layout, np.ones(
        (BS_BLOCK, BS_BLOCK), dtype=bool))).cuda()[None, None]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 3)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), gt, retain_graph=True), 3)
    del o, qt, kt, vt, gt, mask
    bounds = bs_bounds(layout, 1, BS_HEADS, BS_SEQ, BS_DIM, BS_BLOCK,
                       q.element_size())
    rows = {}
    for name, key, lib, errs in (
            ("block_sparse_attention_fwd", "fwd", lib_fwd,
             (report["out"]["max_abs_err"], lse_err)),
            ("block_sparse_attention_bwd_dkv", "dkv", lib_bwd,
             (report["dk"]["max_abs_err"], report["dv"]["max_abs_err"])),
            ("block_sparse_attention_bwd_dq", "dq", lib_bwd,
             (report["dq"]["max_abs_err"],))):
        rows[name] = dict(ms=ms[name], plain_ms=plain_ms[name],
                          library_ms=lib, bound_ms=bounds[key][0],
                          bound_by=bounds[key][1], max_abs_err=max(errs),
                          launches=launches[name], variants=variants[name])
    say("kernel", name="block_sparse_attention", batch=1, seq=BS_SEQ,
        heads=BS_HEADS, head_dim=BS_DIM, block=BS_BLOCK, dtype="bfloat16",
        layout=f"bigbird random={BS_RANDOM} global={BS_GLOBAL} "
        f"window={BS_WINDOW} seed=0", blocks_present=int(layout.sum()),
        blocks_total=int(layout.size), path_launches=launches,
        path_variants=variants, path_dense_calls=dense_calls,
        path_first_call_s=path_s, path_fwd_bwd_ms=path_ms,
        path_equals_kernels=same, rtol=K1_RTOL, l2_tol=K1_L2_TOL, **report,
        times_ms=ms, lists_built_per_call_ms=lists_per_call_ms,
        plain_ms=plain_ms, library_fwd_ms=lib_fwd,
        library_bwd_ms=lib_bwd,
        bound_ms={n: b[0] for n, b in bounds.items()},
        bound_by={n: b[1] for n, b in bounds.items()},
        fraction_of_bound={n: r["bound_ms"] / r["ms"]
                           for n, r in rows.items()},
        clocks_before=clocks_before, clocks_after=clocks_after)
    del q, k, v, g, f32, k_out, lse, delta, dq, dk, dv
    del ref_out, ref_lse, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()

    # a small layout: a query block with no key block, a key block no
    # query block reads, a first row that starts late
    small = np.random.RandomState(8).rand(8, 8) < 0.4
    small[0] = False
    small[0, 6] = True
    small[3] = False
    small[:, 5] = False
    q, k, v, g = bs_case(8 * BS_BLOCK, 4, gen)
    s_out, s_lse, s_delta, s_dq, s_dk, s_dv = bs_kernels(q, k, v, g, small,
                                                         BS_BLOCK)
    f32 = [t.float() for t in (q, k, v, g)]
    ref_out, ref_lse = k4.torch_bs_fwd(*f32[:3], small, BS_BLOCK)
    refs = (ref_out,) + k4.torch_bs_bwd(*f32, s_lse, s_delta, small,
                                        BS_BLOCK)
    small_report = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (s_out, s_dq, s_dk, s_dv), refs):
        bs_check(name, got, want, failures, small_report)
    rows3 = slice(3 * BS_BLOCK, 4 * BS_BLOCK)
    col5 = slice(5 * BS_BLOCK, 6 * BS_BLOCK)
    zeros = bool((s_out[:, rows3] == 0).all() and (s_dq[:, rows3] == 0).all()
                 and (s_dk[:, col5] == 0).all() and
                 (s_dv[:, col5] == 0).all() and
                 (s_lse[..., rows3] <= -1e29).all())
    if not zeros:
        failures.append("K4 small layout: the empty query block or the "
                        "unread key block is not zero")
    say("kernel", name="block_sparse_attention", case="small_empty_row",
        seq=8 * BS_BLOCK, heads=4, layout=small.astype(int).tolist(),
        empty_rows_zero=zeros, **small_report)
    del q, k, v, g, f32, s_out, s_lse, s_delta, s_dq, s_dk, s_dv, refs
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return rows


# -- phase 9 ------------------------------------------------------------

def grad_rel_named(got: dict, want: dict) -> dict:
    return {n: ((got[n].float() - w.float()).norm() /
                w.float().norm()).item() for n, w in want.items()}


def planted_ce_faults():
    """Faults planted in K2's backward for the long-context step's check:
    name -> (wrapper, patch). ``dk_token_tile``: the first chunk's first
    128 tokens left out of dK (their rows of x zero, so both parts of d
    drop out); ``dx_token_tile``: their dx zero."""
    from fengshen_tpu_torch.ops.kernels import fused_ce as k2
    real_dx, real_dk = k2.cuda_ce_bwd_dx, k2.cuda_ce_bwd_dk

    def dk_token_tile(x, d, labels, c_gold, total, dk=None, first=True):
        if first:
            x = x.clone()
            x[:CE_TILE].zero_()
        return real_dk(x, d, labels, c_gold, total, dk, first)

    calls = []

    def dx_token_tile(*a, **kw):
        dx = real_dx(*a, **kw)
        if not calls:
            dx[:CE_TILE].zero_()
        calls.append(1)
        return dx

    return {"dk_token_tile": ("cuda_ce_bwd_dk", dk_token_tile),
            "dx_token_tile": ("cuda_ce_bwd_dx", dx_token_tile)}


#: kernel-name fragments -> the group a profiled kernel's time goes to
PROFILE_GROUPS = (("K1 flash attention", ("flash_",)),
                  ("K2 fused CE", ("ce_fwd_", "ce_d_", "ce_dx_",
                                   "ce_dk_")),
                  ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_xmma")))


def profiled(fn):
    """``fn()`` under ``torch.profiler``: its result, plus the wall time,
    the device-busy time (sum of kernel times; one stream), the idle
    share, the kernel time by PROFILE_GROUPS and the eight kernels that
    take most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for kname, ms in kernels.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in kname for k in keys)), "other")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return (*out, {
        "wall_ms": wall_ms,
        "device_busy_ms": busy if kernels else "not measured: no device "
        "events", "device_idle_share": 1 - busy / wall_ms if kernels else
        "not measured", "group_ms": groups,
        "top_kernels_ms": {k[:80]: v for k, v in top}})


def phase_long_context(workdir: Path):
    """The long-context path on the card: ``configs/long_context_32k.json``
    at full width and window, cut to LONG_LAYERS layers, through the
    kernel bench's ``long_context_fit`` for LONG_STEPS steps (K1 through
    ring attention on one device, K2 through CausalLMModule). Then step
    1 again from the same seed and batch with K2 (under the profiler:
    where a step's device time goes), with K2's plain version in fp32 on
    the same bf16 inputs, and with faults planted in K2's backward."""
    import torch
    from unittest import mock
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.ops.fused_ce import fused_lm_head_ce
    from fengshen_tpu_torch.ops.kernels import (bench, get_entry,
                                                reset_launch_counts)
    from fengshen_tpu_torch.ops.kernels import fused_ce as k2
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer import modules as train_modules

    config = dataclasses.replace(bench.long_context_config(),
                                 num_hidden_layers=LONG_LAYERS)
    seq = config.max_position_embeddings
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer, state, module, wall = bench.long_context_fit(
        config, "cuda", root=str(workdir / "long_context"),
        steps=LONG_STEPS, batch=1)
    launches = {n: get_entry(n).launches for n in K1_NAMES + K2_NAMES}
    variants = {n: dict(get_entry(n).variants) for n in K1_NAMES + K2_NAMES}
    peak = torch.cuda.max_memory_allocated()
    steps = [e for e in trainer.history if "loss" in e]
    n_params = trainer.history[0]["n_params"]
    args = trainer.args
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    losses = [e["loss"] for e in steps]
    chunks = -(-(seq - 1) // k2.BWD_CHUNK)
    want = {"flash_attention_fwd": 2 * LONG_LAYERS * LONG_STEPS,
            "flash_attention_bwd_dkv": LONG_LAYERS * LONG_STEPS,
            "flash_attention_bwd_dq": LONG_LAYERS * LONG_STEPS,
            "fused_ce_fwd": LONG_STEPS,
            "fused_ce_bwd_dx": chunks * LONG_STEPS,
            "fused_ce_bwd_dk": chunks * LONG_STEPS}
    failures = []
    if len(steps) != LONG_STEPS or not all(math.isfinite(x) for x in losses):
        failures.append(f"long context: losses {losses}")
    if launches != want:
        failures.append(f"long context: launches {launches}, want {want}")
    if variants != {n: {"tensor_core": c} for n, c in want.items()}:
        failures.append(f"long context: bf16 must launch only the "
                        f"tensor-core K1 and K2, got {variants}")

    # step 1 again: same seed, same first batch
    rows = bench.long_context_rows(config.vocab_size, seq, LONG_STEPS + 1)
    batch = next(iter(UniversalDataModule(
        args=args, datasets={"train": rows}).train_dataloader()))
    ref_trainer = Trainer(args)
    batch = ref_trainer._to_device(batch)
    grad_step = ref_trainer._make_grad_step(module)
    params = dict(module.model.named_parameters())

    def step1():
        module.init_params(torch.Generator(device="cuda").manual_seed(
            args.seed))
        loss = float(grad_step(batch)["loss"])
        return loss, {n: params[n].grad.detach().clone() for n in LONG_GRADS}

    def plain_ce(hidden, kernel, labels, num_chunks=8, ignore_index=-100):
        return fused_lm_head_ce(hidden.float(), kernel.float(), labels,
                                num_chunks=num_chunks,
                                ignore_index=ignore_index)

    k_loss, k_grads, breakdown = profiled(step1)
    with mock.patch.object(train_modules, "fused_ce_loss", plain_ce):
        p_loss, p_grads = step1()
    fault_rel = {}
    for fault, (wrapper, patch) in planted_ce_faults().items():
        with mock.patch.object(k2, wrapper, patch):
            fault_rel[fault] = grad_rel_named(step1()[1], p_grads)
    rel = grad_rel_named(k_grads, p_grads)
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    del module, grad_step, params, k_grads, p_grads, batch, ref_trainer
    gc.collect()
    torch.cuda.empty_cache()

    step_s = [e["step_time_s"] for e in steps]
    steady = step_s[1:]
    tokens_per_s = seq * len(steady) / sum(steady)
    say("long_context", config="configs/long_context_32k.json",
        layers=LONG_LAYERS, hidden=config.hidden_size,
        heads=config.num_attention_heads,
        kv_heads=config.num_key_value_heads, vocab=config.vocab_size,
        seq=seq, batch=1, dtype=config.dtype,
        attention_impl=config.attention_impl,
        remat_policy=config.remat_policy,
        fused_ce_chunks=config.fused_ce_chunks, params=n_params,
        steps=LONG_STEPS, losses=losses, accs=[e["acc"] for e in steps],
        grad_norms=[e["grad_norm"] for e in steps], step_s=step_s,
        steady_step_s=sum(steady) / len(steady), tokens_per_s=tokens_per_s,
        mfu_bf16=steps[-1]["flops_per_token"] * tokens_per_s / BF16_FLOPS,
        flops_per_token=steps[-1]["flops_per_token"], wall_s=wall,
        max_memory_allocated_gib=peak / 2**30, launches=launches,
        variants=variants,
        step1_fit_loss=losses[0] if losses else None, step1_k2_loss=k_loss,
        step1_plain_loss=p_loss, loss_rel_diff=loss_rel,
        loss_rtol=LONG_LOSS_RTOL, grad_rel_diff=rel,
        grad_rtol=LONG_GRAD_RTOL, planted_fault_grad_rel_diff=fault_rel,
        step1_profile=breakdown)
    if loss_rel > LONG_LOSS_RTOL or max(rel.values()) > LONG_GRAD_RTOL:
        failures.append(f"long context: step 1 with K2 against its plain "
                        f"version: loss {loss_rel}, grads {rel}")
    caught = {f: max(r.values()) > LONG_GRAD_RTOL
              for f, r in fault_rel.items()}
    if not all(caught.values()):
        failures.append(f"long context: a planted K2 fault passed the "
                        f"check: {fault_rel}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# -- phase 10 -----------------------------------------------------------

#: full-depth LoRA fine-tune (phase 10): Ziya-13B at full width and all
#: 40 layers, packed rows, rank-8 adapters on q/k/v/o_proj
LORA_STEPS, LORA_ROWS, LORA_SEQ, LORA_RECORDS = 6, 4, 1024, 14
LORA_RANK, LORA_VAL_EVERY, LORA_VAL_BATCHES = 8, 3, 2
LORA_PROFILE = (4, 5)
#: base tensors held bitwise to their values before the fit
LORA_SAMPLED = ("model.embed_tokens.weight",
                "model.layers.0.self_attn.q_proj.weight",
                "model.layers.20.self_attn.o_proj.weight",
                "model.layers.39.mlp.down_proj.weight",
                "model.norm.weight", "lm_head.weight")
#: resume, preemption, rewind and merge (phase 11): layers kept at Ziya
#: width (a 40-layer fp32 checkpoint would write 52 GB per save), steps,
#: the step the preemption hits, free disk the phase needs
RESUME_LAYERS, RESUME_STEPS, RESUME_SIGTERM_AT = 2, 6, 3
RESUME_MIN_FREE_GIB = 24


def packed_records(n, vocab, seed):
    """Synthetic SFT records (ids as text, for the IdTokenizer) of
    roughly 90-470 tokens each, so rows of 1024 pack 2-8 of them."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def ids(k):
        return " ".join(map(str, rng.randint(3, vocab, k)))
    return [{"query": ids(rng.randint(20, 80)),
             "answer": ids(rng.randint(60, 380))} for _ in range(n)]


def write_jsonl(path: Path, records) -> Path:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


@contextlib.contextmanager
def fit_hook(install):
    """Run ``install(trainer, module)`` at the start of every
    ``Trainer.fit`` (to add an observing callback or a fault plan to the
    Trainer that ``finetune_ziya_llama.main`` builds)."""
    from unittest import mock
    from fengshen_tpu_torch.trainer import trainer as trainer_mod
    real = trainer_mod.Trainer.fit

    def fit(self, module, datamodule):
        install(self, module)
        return real(self, module, datamodule)

    with mock.patch.object(trainer_mod.Trainer, "fit", fit):
        yield


def lora_argv(workdir: Path, model_dir: Path, train: Path, steps: int,
              extra=()) -> list:
    return [str(x) for x in (
        "--model_path", model_dir, "--train_file", train, "--packed",
        "--packed_rows", LORA_ROWS, "--max_seq_length", LORA_SEQ,
        "--train_batchsize", LORA_RECORDS, "--lora_rank", LORA_RANK,
        "--max_steps", steps, "--learning_rate", 1e-3,
        "--scheduler_type", "constant", "--warmup_ratio", 0,
        "--log_every_n_steps", 1, "--seed", 0, "--default_root_dir",
        workdir / "runs", "--device", "cuda", *extra)]


def phase_lora_finetune(workdir: Path):
    """``finetune_ziya_llama.main`` with ``--packed --lora_rank 8`` on
    Ziya-13B at full width and all 40 layers: fp32 base made on the card
    from a seed, bf16 compute, per-layer checkpointing, K1 with segment
    ids; validation every 3 steps over 2 batches, ``/metrics`` scraped
    during the fit, steps 4-5 profiled. Then step 1 again with K1's
    plain version, and with K1 given all-ones segment ids: a planted
    fault that the step-1 bar must reject. Returns K1's launches."""
    import numpy as np
    import torch
    from unittest import mock
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.examples.ziya_llama import finetune_ziya_llama
    from fengshen_tpu_torch.ops import kernels
    from fengshen_tpu_torch.ops.kernels import (get_entry,
                                                reset_launch_counts)
    from fengshen_tpu_torch.ops.lora import LoraLinear
    from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora

    raw = json.loads(ZIYA_CONFIG.read_text())
    (workdir / "model13b").mkdir(parents=True, exist_ok=True)
    (workdir / "model13b" / "config.json").write_text(json.dumps(raw))
    train = write_jsonl(workdir / "lora_train.jsonl", packed_records(
        LORA_STEPS * LORA_RECORDS, raw["vocab_size"], seed=11))
    val = write_jsonl(workdir / "lora_val.jsonl", packed_records(
        LORA_VAL_BATCHES * LORA_RECORDS, raw["vocab_size"], seed=12))
    argv = lora_argv(workdir, workdir / "model13b", train, LORA_STEPS, (
        "--val_file", val, "--val_batchsize", LORA_RECORDS,
        "--val_check_interval", LORA_VAL_EVERY, "--limit_val_batches",
        LORA_VAL_BATCHES, "--metrics_port", 0, "--profile_steps",
        ",".join(map(str, LORA_PROFILE)),
        *no_checkpoints(workdir / "ckpt13b")))

    base0, per_step, scraped = {}, [], {}

    class Probe:
        """K1's launch counts after each step; ``/metrics`` at step 2."""

        def on_train_step_end(self, trainer, state):
            per_step.append([get_entry(n).launches for n in K1_NAMES])
            if trainer.global_step == 2:
                port = trainer._metrics_server.port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=30) as r:
                    scraped["text"] = r.read().decode()

    def install(trainer, module):
        real_init = module.init_params

        def init(generator):
            model = real_init(generator)
            sd = model.state_dict()
            base0.update({n: sd[n].detach().cpu().clone()
                          for n in LORA_SAMPLED})
            return model

        module.init_params = init
        trainer.callbacks.append(Probe())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with fit_hook(install):
        trainer = finetune_ziya_llama.main(argv, tokenizer=IdTokenizer())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: get_entry(n).launches for n in K1_NAMES}
    variants = {n: dict(get_entry(n).variants) for n in K1_NAMES}
    segmented = {n: get_entry(n).segmented for n in K1_NAMES}
    model = trainer.state.model
    sd = model.state_dict()
    base_equal = {n: bool(torch.equal(sd[n].cpu(), base0[n]))
                  for n in LORA_SAMPLED}
    adapters = [m for m in model.modules() if isinstance(m, LoraLinear)]
    lora_b_moved = sum(int(m.lora_b.detach().abs().max() > 0)
                       for m in adapters)
    n_trainable = sum(p.numel() for p in model.parameters()
                      if p.requires_grad)
    hist = trainer.history
    steps = [e for e in hist if "loss" in e]
    vals = [e for e in hist if "val_loss" in e]
    events = {e.get("event") for e in hist}
    trace = workdir / "runs" / "profile" / "trace-{}-{}.json".format(
        *LORA_PROFILE)
    from torch.autograd import DeviceType
    dev_us = {}
    for ev in trainer.profiler.events():
        if ev.device_type == DeviceType.CUDA:
            dev_us[ev.name] = dev_us.get(ev.name, 0) + \
                ev.time_range.elapsed_us()
    busy_ms = sum(dev_us.values()) / 1e3
    k1_ms = sum(us for name, us in dev_us.items()
                if "flash_" in name) / 1e3
    profiled_step_s = next(e["step_time_s"] for e in steps
                           if e["step"] == LORA_PROFILE[1])
    del trainer, model, sd, adapters
    gc.collect()
    torch.cuda.empty_cache()

    # step 1 again from the same seed and batch with K1's plain version
    args = finetune_ziya_llama.parse_args(argv)
    ref_trainer = Trainer(args)
    module = finetune_ziya_llama.Llama(args, device="cuda")
    module.config.packed_sequences = True
    module = maybe_wrap_lora(module, args)
    module.setup("fit")
    module.init_params(torch.Generator(device="cuda").manual_seed(0))
    collator = finetune_ziya_llama.LlamaSFTPackedCollator(
        IdTokenizer(), max_seq_length=LORA_SEQ, fixed_rows=LORA_ROWS)
    host = next(iter(UniversalDataModule(
        collate_fn=collator, args=args).train_dataloader()))
    segs = [len(set(row[row > 0].tolist()))
            for row in np.asarray(host["attention_mask"])]
    real_tokens = int((np.asarray(host["attention_mask"]) > 0).sum())
    with mock.patch.object(kernels, "kernel_choice",
                           lambda name, tensor: "plain"):
        ref = ref_trainer._make_grad_step(module)(
            ref_trainer._to_device(host))
    ref_loss, ref_norm = float(ref["loss"]), float(ref["grad_norm"])

    # a planted fault: K1 given all-ones segment ids (every packed
    # example attends to the ones before it in its row) must fail the
    # bar below, so the bar can see a K1 that ignores the segments
    from fengshen_tpu_torch.models.llama import modeling_llama
    real_fa = modeling_llama.flash_attention

    def unsegmented(q, k, v, causal=False, segment_ids=None):
        return real_fa(q, k, v, causal=causal,
                       segment_ids=None if segment_ids is None
                       else torch.ones_like(segment_ids))

    with mock.patch.object(modeling_llama, "flash_attention",
                           unsegmented):
        bad = ref_trainer._make_grad_step(module)(
            ref_trainer._to_device(host))
    fault_loss_rel = abs(float(bad["loss"]) - ref_loss) / abs(ref_loss)
    fault_norm_rel = abs(float(bad["grad_norm"]) - ref_norm) / \
        abs(ref_norm)
    del ref_trainer, module, ref, bad
    gc.collect()
    torch.cuda.empty_cache()

    losses = [e["loss"] for e in steps]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    norm_rel = abs(steps[0]["grad_norm"] - ref_norm) / abs(ref_norm)
    layers = raw["num_hidden_layers"]
    val_steps = {e["step"] for e in vals}
    want_step = [[2 * layers + layers * LORA_VAL_BATCHES *
                  (s in val_steps), layers, layers]
                 for s in range(1, LORA_STEPS + 1)]
    got_step = [[b - a for a, b in zip([0, 0, 0] if i == 0 else
                                       per_step[i - 1], cur)]
                for i, cur in enumerate(per_step)]
    steady = [e["step_time_s"] for e in steps
              if e["step"] not in (1, LORA_VAL_EVERY + 1) and
              e["step"] < LORA_PROFILE[0] + 1]
    tokens = LORA_ROWS * LORA_SEQ
    mfu = steps[-1]["flops_per_token"] * tokens / \
        (sum(steady) / len(steady)) / BF16_FLOPS
    metric_step = re.search(r"^fstpu_train_step (\d+)",
                            scraped.get("text", ""), re.M)
    say("lora_finetune", layers=layers, hidden=raw["hidden_size"],
        heads=raw["num_attention_heads"], vocab=raw["vocab_size"],
        rank=LORA_RANK, trainable_params=n_trainable,
        rows=LORA_ROWS, seq=LORA_SEQ, records_per_batch=LORA_RECORDS,
        segments_per_row_step1=segs, real_tokens_step1=real_tokens,
        steps=LORA_STEPS, losses=losses,
        grad_norms=[e["grad_norm"] for e in steps],
        val_losses=[e["val_loss"] for e in vals],
        val_steps=sorted(val_steps),
        step_s=[e["step_time_s"] for e in steps], steady_steps_s=steady,
        tokens_per_s=tokens * len(steady) / sum(steady),
        mfu_bf16=mfu, mfu_note="flops_per_token counts the base's weight "
        "gradients, which LoRA does not compute: reads high",
        profiled_step_s=profiled_step_s,
        profiled_busy_ms=busy_ms if dev_us else "not measured",
        k1_ms_in_profile=k1_ms if dev_us else "not measured",
        k1_share_of_busy=k1_ms / busy_ms if dev_us else "not measured",
        wall_s=wall, max_memory_allocated_gib=peak / 2**30,
        launches=launches, variants=variants, segmented=segmented,
        launches_per_step=got_step, base_bitwise_equal=base_equal,
        lora_b_moved=f"{lora_b_moved}/{4 * layers}",
        metrics_scraped_step=metric_step and int(metric_step.group(1)),
        trace=str(trace), trace_exists=trace.exists(),
        plain_step1_loss=ref_loss, plain_step1_grad_norm=ref_norm,
        loss_rel_diff=loss_rel, grad_norm_rel_diff=norm_rel,
        loss_rtol=TRAIN_LOSS_RTOL, grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
        unsegmented_fault_loss_rel_diff=fault_loss_rel,
        unsegmented_fault_grad_norm_rel_diff=fault_norm_rel)
    failures = []
    if fault_loss_rel <= TRAIN_LOSS_RTOL and \
            fault_norm_rel <= TRAIN_GRAD_NORM_RTOL:
        failures.append(f"the planted unsegmented K1 passed the step-1 "
                        f"bar (loss {fault_loss_rel}, grad norm "
                        f"{fault_norm_rel})")
    if len(steps) != LORA_STEPS or not all(map(math.isfinite, losses)):
        failures.append(f"losses {losses}")
    if len(vals) != LORA_STEPS // LORA_VAL_EVERY or not all(
            math.isfinite(e["val_loss"]) for e in vals):
        failures.append(f"validation entries {vals}")
    if not all(base_equal.values()):
        failures.append(f"base tensors moved: {base_equal}")
    if lora_b_moved != 4 * layers:
        failures.append(f"lora_b moved in {lora_b_moved} of {4 * layers}")
    if got_step != want_step:
        failures.append(f"K1 launches per step {got_step}, want "
                        f"{want_step}")
    if variants != {n: {"tensor_core": c} for n, c in launches.items()} \
            or segmented != launches:
        failures.append(f"K1 variants {variants}, with segment ids "
                        f"{segmented}, of {launches}")
    if not metric_step or int(metric_step.group(1)) < 1:
        failures.append("/metrics showed no fstpu_train_step")
    if not trace.exists() or not {"profile_start",
                                  "profile_stop"} <= events:
        failures.append(f"no profile trace at {trace}")
    if loss_rel > TRAIN_LOSS_RTOL or norm_rel > TRAIN_GRAD_NORM_RTOL:
        failures.append(f"step 1 with K1 (loss {losses[0]}, grad norm "
                        f"{steps[0]['grad_norm']}) against the plain "
                        f"attention (loss {ref_loss}, grad norm "
                        f"{ref_norm})")
    if failures:
        raise AssertionError("lora fine-tune: " + "; ".join(failures))
    return launches


# -- phase 11 -----------------------------------------------------------

def lora_tensors(model) -> dict:
    from fengshen_tpu_torch.ops.lora import lora_state
    return {k: v.detach().cpu().clone()
            for k, v in lora_state(model).items()}


def phase_lora_resume(workdir: Path, prompts, card):
    """Resume, preemption, rewind and merge-to-serve on Ziya width cut
    to 2 layers, fp32 base loaded from a safetensors checkpoint written
    here, LoRA rank 8, a checkpoint every 2 steps (``save_top_k`` 2).
    Run A trains 6 steps; run B is preempted by a real SIGTERM at step 3
    and run C resumes it: C's losses for steps 4-6 and its final
    adapters must equal A's. The merge CLI's output is served through
    ``Pipeline(model=dir)`` and K3 with tokens equal to the in-memory
    merge; the newest step truncated falls back to the one before; NaN
    steps 5-6 rewind to the step-4 checkpoint and dump a bundle."""
    import shutil
    import signal
    import torch
    from fengshen_tpu_torch.examples.ziya_llama import finetune_ziya_llama
    from fengshen_tpu_torch.models.llama import (LlamaConfig,
                                                 LlamaForCausalLM)
    from fengshen_tpu_torch.ops import lora
    from fengshen_tpu_torch.ops.kernels import get_entry
    from fengshen_tpu_torch.pipelines.text_generation import (IdTokenizer,
                                                              Pipeline)
    from fengshen_tpu_torch.resilience import (FaultPlan,
                                               truncate_checkpoint_step)
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.trainer import trainer as trainer_mod
    from fengshen_tpu_torch.trainer.modules import maybe_wrap_lora

    free = shutil.disk_usage(workdir).free / 2**30
    if free < RESUME_MIN_FREE_GIB:
        raise AssertionError(f"lora resume: {free:.1f} GiB free under "
                             f"{workdir}, the phase needs "
                             f"{RESUME_MIN_FREE_GIB}")
    t_phase = time.perf_counter()
    raw = json.loads(ZIYA_CONFIG.read_text())
    raw["num_hidden_layers"] = RESUME_LAYERS
    model_dir = workdir / "model2"
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(raw))
    cfg = LlamaConfig.from_pretrained(str(model_dir))
    seed_model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    written = write_safetensors(model_dir / "model.safetensors", {
        k: v.to(torch.bfloat16)
        for k, v in seed_model.state_dict().items()})
    del seed_model
    train = write_jsonl(workdir / "resume_train.jsonl", packed_records(
        RESUME_STEPS * LORA_RECORDS, raw["vocab_size"], seed=13))
    io = {"gib_written": written / 2**30, "gib_read": 0.0, "write_s": 0.0,
          "read_s": 0.0}

    def run(name, steps=RESUME_STEPS, every=2, extra=(), install=None):
        ckpt = workdir / f"ckpt_{name}"
        argv = lora_argv(workdir / name, model_dir, train, steps, (
            "--save_ckpt_path", ckpt, "--load_ckpt_path", ckpt,
            "--every_n_train_steps", every, "--save_top_k", 2, *extra))
        with fit_hook(install or (lambda t, m: None)):
            trainer = finetune_ziya_llama.main(argv,
                                               tokenizer=IdTokenizer())
        cb = next(c for c in trainer.callbacks if hasattr(c, "stats"))
        io["gib_written"] += cb.stats["bytes_written"] / 2**30
        io["gib_read"] += cb.stats["bytes_read"] / 2**30
        io["write_s"] += cb.stats["save_s"]
        io["read_s"] += cb.stats["restore_s"]
        return trainer, ckpt

    failures = []
    trainer_a, ckpt_a = run("a")
    losses_a = {e["step"]: e["loss"] for e in trainer_a.history
                if "loss" in e}
    adapters_a = lora_tensors(trainer_a.state.model)

    # merge-to-serve: the CLI on A's newest step, against A's model
    # merged in memory, both served through K3
    merged_dir = workdir / "merged"
    lora.main(["--input_path", str(ckpt_a), "--output_path",
               str(merged_dir), "--config_path", str(model_dir)])
    model_a = lora.merge_lora(trainer_a.state.model)
    entry = get_entry("decode_attention")
    want, _ = serve_run(Pipeline(module=model_a, tokenizer=IdTokenizer(),
                                 max_new_tokens=NEW_TOKENS, device="cuda"),
                        "paged", prompts, entry)
    served, k3 = serve_run(Pipeline(model=str(merged_dir),
                                    tokenizer=IdTokenizer(),
                                    max_new_tokens=NEW_TOKENS,
                                    device="cuda"),
                           "paged", prompts, entry)
    if served != want or not k3:
        failures.append(f"merged checkpoint served {k3} K3 launches, "
                        f"tokens equal {served == want}")
    del trainer_a, model_a
    shutil.rmtree(merged_dir)

    # the newest step truncated: the restore falls back to the one before
    newest = max(int(p.name) for p in ckpt_a.iterdir() if p.name.isdigit())
    truncate_checkpoint_step(str(ckpt_a), newest)
    args = finetune_ziya_llama.parse_args(lora_argv(
        workdir / "trunc", model_dir, train, RESUME_STEPS,
        ("--load_ckpt_path", ckpt_a, "--save_ckpt_path",
         workdir / "ckpt_trunc")))
    probe = Trainer(args)
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        UniversalCheckpoint)
    probe.callbacks.append(UniversalCheckpoint(args))
    module = maybe_wrap_lora(finetune_ziya_llama.Llama(args,
                                                       device="cuda"), args)
    probe.restore_for_predict(module)
    rejected = [e["ckpt_step"] for e in probe.history
                if e.get("event") == "checkpoint_restore_rejected"]
    fell_back_to = probe.global_step
    if rejected != [newest] or fell_back_to != newest - 2:
        failures.append(f"truncated step {newest}: rejected {rejected}, "
                        f"restored step {fell_back_to}")
    del probe, module
    shutil.rmtree(ckpt_a)

    # preemption by a real SIGTERM at step 3, then the resume
    plan_b = FaultPlan(sigterm_at_step=RESUME_SIGTERM_AT)

    def preempt(trainer, module):
        handler = trainer_mod._SIGTERM_STATE["handler"]
        if handler is None or signal.getsignal(signal.SIGTERM) is not \
                handler:
            raise AssertionError("the Trainer installed no SIGTERM "
                                 "handler: the planted SIGTERM would "
                                 "kill the smoke")
        plan_b.install(trainer)

    trainer_b, ckpt_b = run("b", install=preempt)
    saved_b = [e for e in trainer_b.history
               if e.get("event") == "preempted_saved"]
    del trainer_b
    trainer_c, _ = run("b")
    losses_c = {e["step"]: e["loss"] for e in trainer_c.history
                if "loss" in e}
    adapters_c = lora_tensors(trainer_c.state.model)
    del trainer_c
    shutil.rmtree(ckpt_b)
    tail = range(RESUME_SIGTERM_AT + 1, RESUME_STEPS + 1)
    loss_equal = [losses_c.get(s) == losses_a[s] for s in tail]
    parted = [k for k in adapters_a
              if not torch.equal(adapters_a[k], adapters_c[k])]
    worst = max((((adapters_a[k] - adapters_c[k]).norm() /
                  adapters_a[k].norm().clamp_min(1e-30)).item()
                 for k in parted), default=0.0)
    if [e["step"] for e in saved_b] != [RESUME_SIGTERM_AT]:
        failures.append(f"preempted_saved events {saved_b}")
    if not all(loss_equal) or parted:
        failures.append(f"resume parted from the uninterrupted run: "
                        f"losses {[losses_c.get(s) for s in tail]} vs "
                        f"{[losses_a[s] for s in tail]}, first adapter "
                        f"{parted[:1]}, worst rel L2 {worst}")

    # two guarded NaN steps (5 and 6) rewind to the step-4 checkpoint
    plan_r = FaultPlan(nan_loss_at_steps={4, 5})
    trainer_r, ckpt_r = run("r", every=4, extra=(
        "--max_consecutive_bad_steps", 2),
        install=lambda t, m: plan_r.install(t))
    rewinds = [e for e in trainer_r.history if e.get("event") == "rewind"]
    bundles = sorted((workdir / "r" / "runs" / "flightrec").glob(
        "dump-*-rewind"))
    end_step, end_bad = trainer_r.global_step, trainer_r.state.bad_step_count
    del trainer_r
    shutil.rmtree(ckpt_r)
    if [(e["from_step"], e["to_step"]) for e in rewinds] != [(6, 4)] or \
            not bundles or end_step != RESUME_STEPS:
        failures.append(f"rewind events {rewinds}, bundles {bundles}, "
                        f"ended at step {end_step}")
    gc.collect()
    torch.cuda.empty_cache()
    say("lora_resume", card=card, layers=RESUME_LAYERS, steps=RESUME_STEPS,
        sigterm_at=RESUME_SIGTERM_AT, losses_a=losses_a,
        losses_c=losses_c, resume_losses_bitwise=loss_equal,
        adapters_parted=len(parted), adapters_worst_rel_l2=worst,
        preempted_saved=[e["step"] for e in saved_b],
        merged_served_equal=served == want, merged_k3_launches=k3,
        truncated_step=newest, rejected=rejected,
        restored_step=fell_back_to,
        rewinds=[(e["from_step"], e["to_step"]) for e in rewinds],
        rewind_bundles=[b.name for b in bundles],
        rewind_bad_step_count=end_bad, **io,
        write_gib_per_s=io["gib_written"] / max(io["write_s"], 1e-9),
        read_gib_per_s=io["gib_read"] / max(io["read_s"], 1e-9),
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("lora resume: " + "; ".join(failures))
    return k3


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
    # seconds from the start at the end of each phase (the script's time
    # limit is shared by every slice's phases)
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t_start, 1)

    card = phase_device()
    build_s = phase_build()
    rows = phase_kernels()
    int8_rows = phase_int8_kernels()
    k1_rows = phase_flash_kernels()
    k2_rows = phase_ce_kernels()
    k4_rows = phase_block_sparse()
    mark("3_kernels")
    model, pipe, prompts, runs, launches = phase_main_path()
    phase_teacher_forced(model, prompts, runs)
    mark("4_serving")
    int8_launches = phase_int8_serving(model, pipe, prompts, runs)
    mark("5_int8_serving")
    verify_launches = phase_spec_serving(model, pipe, card)
    mark("5b_spec_serving")
    launches += phase_serving_surface(model, pipe, prompts, runs, card)
    mark("4c_serving_surface")
    launches += phase_checkpoint(prompts, card)
    mark("4d_checkpoint")
    phase_profile(pipe, prompts)
    phase_profile(pipe, prompts, kv_dtype="int8")
    phase_profile(pipe, prompts, engine_args={
        "spec_mode": "prompt_lookup", "spec_gamma": SPEC_GAMMA})
    phase_profile(pipe, prompts, layout="slot", engine_args={
        "spec_mode": "self_draft", "spec_gamma": SPEC_GAMMA,
        "spec_draft_layers": SPEC_DRAFT_LAYERS})
    mark("6_profile")
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    phase_fp32_serving(prompts)
    mark("7_fp32_serving")
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches = phase_training(Path(tmp))
        mark("8_training")
        long_launches = phase_long_context(Path(tmp))
        mark("9_long_context")
        lora_launches = phase_lora_finetune(Path(tmp))
        mark("10_lora_finetune")
        launches += phase_lora_resume(Path(tmp), prompts, card)
        mark("11_lora_resume")
    from fengshen_tpu_torch.ops.kernels import get_entry
    entry = get_entry("decode_attention")
    main_row = rows[("paged", 1)]
    int8_row = int8_rows[("bfloat16", "paged", 1)]
    kernels = [{
        "name": entry.name, "route": "cuda", "source": entry.source,
        "replaces": entry.replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "splits": main_row["splits"]}, {
        "name": f"{entry.name}_int8", "route": "cuda",
        "source": entry.source, "replaces": entry.replaces,
        "launches": int8_launches,
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows.values()),
        "ms": int8_row["ms"], "plain_ms": int8_row["plain_ms"],
        "bound_ms": int8_row["bound_ms"], "bound_by": int8_row["bound_by"],
        "library_ms": int8_row["library_ms"],
        "splits": int8_row["splits"]}]
    # the same kernel on the speculative verify windows (S = gamma+1):
    # launches from phase 5b's runs, times from phase 3's S 5 rows
    for name, row, dtype in (
            (f"{entry.name}_verify", rows[("paged", SPEC_GAMMA + 1)],
             "bfloat16"),
            (f"{entry.name}_int8_verify",
             int8_rows[("bfloat16", "paged", SPEC_GAMMA + 1)], "int8")):
        kernels.append({
            "name": name, "route": "cuda", "source": entry.source,
            "replaces": entry.replaces,
            "launches": verify_launches[dtype],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "splits": row["splits"], "variant": f"s{SPEC_GAMMA + 1}"})
    for name in K1_NAMES:
        e, r = get_entry(name), k1_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": k1_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "variant": "tensor_core",
            "launches_by_path": {"sft_4_layers": k1_launches[name],
                                 "lora_40_layers_packed":
                                     lora_launches[name],
                                 "long_context": long_launches[name]}})
    for name in K2_NAMES:
        e, r = get_entry(name), k2_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": long_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "variant": "tensor_core"})
    for name in K4_NAMES:
        e, r = get_entry(name), k4_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "variant": next(iter(r["variants"]))})
    say("done", seconds=time.perf_counter() - t_start, build_s=build_s,
        phase_end_s=marks, card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
