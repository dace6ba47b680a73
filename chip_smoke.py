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
   ``--device``, so on the card), gives the in-memory merge's tokens.
   Free disk is checked first; GiB and seconds written and read are
   printed;
12. classification: ``finetune_classification.main`` with the flags of
   the reference's AFQMC shell on Erlangshen-MegatronBert-1.3B
   (``configs/erlangshen_megatron_bert_1.3b.json``: all 24 layers at
   full width, fp32 weights made on the card from a seed, bf16 compute)
   over AFQMC-shaped splits made from a seed and the phase's own pair
   tokenizer: 40 steps of 8 x 128, validation every 10 steps with
   checkpoints kept by ``val_acc``, then ``predict.json`` from the best
   one, which ``--do_predict_only`` must write again; on those weights
   the bf16 forward held to fp32 compute (the padding mask dropped, a
   planted fault, must fail that bar) and a row's fp32 logits held
   across padding of 64 and 128; a 2-layer model at that width written
   as an HF-named checkpoint and read back through
   ``load_torch_checkpoint`` with bitwise logits, its encoder imported
   by the classification module. K1-K4 launch 0 times (the family runs
   the dense attention). Free disk is checked first; step time,
   samples/s, tokens/s, MFU, peak memory and checkpoint GiB/s are
   printed;
13. Wenzhong: with 70 GiB of device memory free (checked first, never
   a shallower model), ``finetune_wenzhong.main`` with the flags of the
   reference's medicalQA shell on Wenzhong-GPT2-3.5B
   (``configs/wenzhong_gpt2_3.5b.json``: all 30 blocks at width 3072,
   fp32 weights made on the card from a seed, bf16 compute, per-block
   checkpointing) for 8 steps of 1 x 512 over one repeated record and
   one validation, steps 5-6 profiled: step time, tokens/s, MFU, peak
   memory, losses (finite, falling); K1-K4 launch 0 times. Step 1 again
   with ``fused_ce_chunks`` 8, through K2 under GPT-2's tied head (one
   launch of each of its kernels), held to the materialised-logits
   step (loss within 2e-2, grad norm within 5e-2); K2 against its plain
   version at that shape (T 511, H 3072, V 50304) as in phase 3; the
   bf16 forward held to fp32 compute on 1 x 128; 32 tokens of
   ``yuyuan_qa.answer`` decoded over GPT-2's cache, each within
   TF_MARGIN of one uncached forward's argmax; then at 2 blocks an
   HF-named safetensors export answered by ``yuyuan_qa.main`` from a
   piped stdin, and a fine-tune preempted by a real SIGTERM after step
   2 and resumed, step 3 bitwise equal to the uninterrupted run's;
14. Randeng summarization: ``seq2seq_summary.main`` with the flags of
   the reference's 784M summary shell on Randeng-T5-784M
   (``configs/randeng_t5_784m.json``: all 24 + 24 layers at full width,
   784,108,544 parameters checked first, fp32 weights made on the card
   from a seed, bf16 compute) over LCSTS-shaped records made from a seed
   and the phase's own character tokenizer: 20 steps of 64 x (128 +
   64), validation every 10 steps with checkpoints kept by
   ``val_loss``, then greedy ``predict.json`` over 128 test records with
   ROUGE; ``--do_eval_only`` writes a beam-4 file and the greedy file
   again, byte for byte; the bf16 forward held to fp32 compute (the
   encoder padding mask dropped must fail that bar); 8 rows of cached
   greedy decode held to one uncached forward, their beam-4 outputs
   re-scored no worse than greedy; a 2-layer HF export read back
   through ``load_hf_pretrained`` with bitwise logits. K1-K4 launch 0
   times. Free disk is checked first; step time, tokens/s (encoder and
   decoder tokens), MFU, peak memory, checkpoint GiB/s and decode ms per
   step (greedy and beam 4, batch 64, with a profiled greedy window)
   are printed;
15. Randeng pretraining: ``pretrain_t5.main`` with the flags of the
   reference's ``pretrain_randeng_t5_char_700M.sh`` on Randeng-T5-784M
   at all 24 + 24 layers (the parameter count checked first): 20 steps
   of 8 x (512 + 114) span-corruption tokens over text records made
   from a seed, one checkpoint, every batch's labels holding its
   input's sentinels in order (shifted sentinels must fail that check),
   then ``--do_eval_only`` (one validation sweep, no step) and the bf16
   forward held to fp32 compute on padded rows (the encoder mask
   dropped must fail the bar); then ``finetune_t5_cmrc.main`` with the
   CMRC shell's flags at the same geometry (its batch of 32, or the
   largest the card's memory takes, reckoned first and printed), 10
   steps, and its beam-4 predictions from ``--do_eval_only``;
16. the other seq2seq families at the JAX package's default geometries
   and full depth: ``pretrain_bart.main`` (BART 6 + 6 of 768,
   139,470,681 parameters) over an indexed corpus the phase writes with
   the port's builder, ``finetune_bart.main`` (``--mask_ans_style
   anstoken``) on the weights it leaves, ``pretrain_pegasus.main``
   (Pegasus 16 + 16 of 1024, 568,796,007; gap sentences at 0.25) and
   ``finetune_deltalm.main`` (DeltaLM 12 + 6 of 768, 362,510,592; 16 x
   (256 + 256), label smoothing 0.1), then 8 rows of cached greedy
   DeltaLM decode held to one uncached forward. Phases 15-16 check free
   device memory and disk first, launch K1-K4 0 times, and print step
   time, tokens/s, peak memory and losses per fit;
17. MLM pretraining of the Erlangshen encoders: (a) on the card's host,
   an indexed corpus of 10^6 documents and about 1.1e8 tokens written
   with the port's builder, the index helpers compiled from
   ``csrc/index_helpers.cpp`` and timed with ``build_mapping`` (509,
   short windows 0.1; every window inside its document),
   ``build_sample_idx`` (512) and ``build_blending_indices`` (0.7 /
   0.3), the last two bitwise equal to their plain versions; (b)
   ``pretrain_erlangshen.main`` with ``pretrain_erlangshen_base.sh``'s
   flags on Erlangshen-MegatronBert-1.3B at all 24 layers, 20 steps of
   the shell's 32 rows of 512 or the batch the memory probe allows,
   steps 5-6 profiled, the bf16 MLM logits held to fp32 compute on the
   trained weights (2e-2) and on the step-0 weights (5e-2; there the
   padding mask dropped must fail that bar), then two steps on rows of a
   ``BertDataset`` over (a)'s corpus; (c) ``pretrain_deberta.main`` on
   Erlangshen-DeBERTa-v2-710M at all 24 layers likewise, its MFU from a
   FLOP count that counts c2p and p2c as Q K^T; (d) ``pretrain_bert.main``
   on bert-base-chinese at 32 x 512 with a checkpoint after step 5 and a
   run resumed from it whose step 6 loss equals the uninterrupted run's.
   Words are cut two characters a word (no ``jieba`` on the card's
   machine); parameter counts, free device memory (60 GiB) and disk (3
   GiB) are checked first; K1-K4 launch 0 times; step time, tokens/s,
   MFU, peak memory and losses are printed per fit;
18. Taiyi Stable Diffusion at full SD-1.x width and depth (UNet
   859,520,964 and VAE 83,653,863 parameters, checked first; a BERT-base
   text tower; 512 px images and 77-token captions made from a seed;
   fp32): the SD-1.x test towers on the card held to the CPU within
   SD_CPU_RTOL; ``finetune.main`` with ``--faithful_towers`` for 4 steps
   at the batch the memory probe allows (8 wanted), step 4 profiled:
   losses finite, the UNet moved, the frozen text tower and VAE bitwise
   unchanged, step time, peak memory, the step's FLOPs
   (``FlopCounterMode``) and MFU against FP32_FLOPS; ``demo.main`` on the
   trained module at 512 px, guidance 7.5, 20 denoise steps (the demo's
   default is 50); then the module behind ``Pipeline`` (4 steps),
   ``BatchImageEngine(max_batch=2)`` and the stdlib server:
   ``/healthz`` 503 before warmup and 200 after, three concurrent POSTs
   each a [512, 512, 3] uint8 image, a batch of 2 in ``/stats``, and the
   drain with one request in flight (a late POST 503 ``draining``). No
   checkpoint is written; K1-K4 launch 0 times.

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
import io
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


def ce_case(gen, tokens=CE_TOKENS, hidden=CE_HIDDEN, vocab=CE_VOCAB):
    """K2's operands at a path's shape (default: the long-context one):
    x like final-norm hidden states (unit rms), the head at the
    configs' initializer range 0.02,
    bf16; labels uniform over the vocab, about 3 % ignored (-100) and 10 %
    set to the fp32 argmax, so that n_correct carries signal."""
    import torch
    from fengshen_tpu_torch.ops.kernels.fused_ce import torch_ce_token_stats
    x = torch.randn(tokens, hidden, generator=gen,
                    device="cuda").bfloat16()
    w = (torch.randn(hidden, vocab, generator=gen, device="cuda") *
         0.02).bfloat16()
    labels = torch.randint(0, vocab, (tokens,), generator=gen,
                           device="cuda", dtype=torch.int32)
    u = torch.rand(tokens, generator=gen, device="cuda")
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


def phase_ce_kernels(tokens=CE_TOKENS, hidden=CE_HIDDEN, vocab=CE_VOCAB,
                     label="fused_ce", seed=3):
    """K2 against its plain version at a path's shape: by default the
    long-context one (T = 32767, H = 4096, V = 32000, bf16); phase 13
    gives Wenzhong's (T = 511, H = 3072, V = 50304). The plain versions
    run in fp32 on the same bf16 inputs (the kernels keep fp32 scores;
    the plain version run in bf16 rounds them); the backward's take the
    kernel's lse and the loss's cotangents. The check is also shown to
    reject planted faults: the last vocab tile left out of the forward
    stats of one token in 97 and of every token labelled in that tile,
    and one 128-token tile left out of dK. Times of the kernels, the
    plain versions on the kernels' (bf16) inputs and torch's
    materialised-logits CE (forward, and its autograd backward, which
    gives dx and dK in one call)."""
    import torch
    import torch.nn.functional as F
    from fengshen_tpu_torch.ops.kernels import fused_ce as k2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, w, labels = ce_case(gen, tokens, hidden, vocab)
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
    rows = torch.arange(tokens, device="cuda")
    rows = rows[(rows % 97 == 0) | (labels >= vocab - CE_TILE)]
    cut = wf[:, :vocab - CE_TILE]
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
    t0 = tokens // 2
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
    bounds = ce_bounds(tokens, hidden, vocab, x.element_size())
    rows_out = {}
    for name, key, lib, err in (
            ("fused_ce_fwd", "fwd", lib_fwd, max(stat_err.values())),
            ("fused_ce_bwd_dx", "dx", lib_bwd, report["dx"]["max_abs_err"]),
            ("fused_ce_bwd_dk", "dk", lib_bwd, report["dk"]["max_abs_err"])):
        rows_out[name] = dict(ms=ms[name], plain_ms=plain_ms[name],
                              library_ms=lib, bound_ms=bounds[key][0],
                              bound_by=bounds[key][1], max_abs_err=err)
    say("kernel", name=label, tokens=tokens, hidden=hidden,
        vocab=vocab, dtype="bfloat16", bwd_chunk=k2.BWD_CHUNK,
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


# -- phase 12 -----------------------------------------------------------

#: classification phase (12): Erlangshen-MegatronBert-1.3B at its
#: published geometry, run with the flags of the reference's non-offload
#: AFQMC shell (finetune_classification_bert-3.9B_afqmc.sh), AFQMC-shaped
#: splits made from a seed (train, dev, test rows), CLS_STEPS steps with
#: validation every CLS_VAL_EVERY
ERLANGSHEN_CONFIG = ROOT / "configs" / "erlangshen_megatron_bert_1.3b.json"
CLS_ROWS = {"train": 256, "dev": 64, "test": 64}
CLS_STEPS, CLS_VAL_EVERY, CLS_BATCH, CLS_LEN = 40, 10, 8, 128
#: AFQMC sentences are short: 8-28 characters each, so a pair fits 64
#: tokens and the padding check can encode it at 64 and at 128
CLS_CHARS, CLS_SENT_LEN = 3000, (8, 29)
#: free GiB the phase needs: 3 kept weights-only fp32 saves of ~5 GB and
#: a fourth before the worst is pruned, and a 2-layer checkpoint
CLS_MIN_FREE_GIB = 22
#: the 24-layer forward in bf16 against fp32 compute on the same weights
#: and dev batch: ||logits_bf16 - logits_fp32|| / ||logits_fp32||. bf16
#: rounds every product and activation to 2^-8 relative; through 24
#: pre-LN layers and the pooler a sound H100 run moved the logits by
#: 2.8e-3 (PERF.md §6), so 2e-2 leaves seven times that. The padding
#: mask dropped (the planted fault) lets every token attend to the pads,
#: 70 % of the dev rows' tokens: 0.174 in that run
CLS_BF16_RTOL = 2e-2
#: the steps traced with torch.profiler (the window opens before step 5
#: and closes before step 7: steps 5 and 6, no validation among them),
#: and the kernel-name groups their device time is summed by (the first
#: group whose key a kernel's name holds)
CLS_PROFILE = (4, 6)
CLS_PROFILE_GROUPS = (
    ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("copies and casts", ("direct_copy", "copy_kernel")),
    ("reductions", ("reduce_kernel", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized")),
    ("random", ("distribution", "philox", "curand")))
#: a row's fp32 logits with its padding grown from 64 to 128 tokens: the
#: pads' scores get a -1e9 bias and exp() of it is 0 in fp32, so only
#: GEMMs of another shape differ, by fp32 rounding
CLS_PAD_ATOL = 1e-4
CLS_CKPT_LAYERS = 2


class PairTokenizer:
    """A character-level tokenizer with the call signature of HF's
    ``BertTokenizer`` that ``TaskCollator`` uses (the card's machine has
    no ``transformers``): ``[CLS] a [SEP] b [SEP]`` with token types 0
    and 1, or ``[CLS] a [SEP]``; ``longest_first`` truncation; right
    padding to ``max_length``; numpy arrays. Its vocabulary is the
    phase's own characters after the five special tokens."""

    pad_token_id, unk_id, cls_id, sep_id = 0, 1, 2, 3
    eos_token, sep_token = None, "[SEP]"

    def __init__(self, chars: str):
        self.vocab = {c: i + 5 for i, c in enumerate(chars)}

    def __call__(self, texts, pairs=None, max_length=128,
                 padding="max_length", truncation=True,
                 return_tensors="np"):
        import numpy as np
        del padding, truncation, return_tensors
        out = {k: np.zeros((len(texts), max_length), np.int64)
               for k in ("input_ids", "token_type_ids", "attention_mask")}
        for r, text in enumerate(texts):
            a = [self.vocab.get(c, self.unk_id) for c in text]
            b = None if pairs is None else \
                [self.vocab.get(c, self.unk_id) for c in pairs[r]]
            budget = max_length - (2 if b is None else 3)
            while len(a) + len(b or ()) > budget:
                (a if b is None or len(a) > len(b) else b).pop()
            ids = [self.cls_id] + a + [self.sep_id]
            types = [0] * len(ids)
            if b is not None:
                ids += b + [self.sep_id]
                types += [1] * (len(b) + 1)
            out["input_ids"][r, :len(ids)] = ids
            out["token_type_ids"][r, :len(ids)] = types
            out["attention_mask"][r, :len(ids)] = 1
        return out


def afqmc_rows(n: int, chars: str, rng, labelled: bool, start: int = 0):
    def sentence():
        return "".join(rng.choice(list(chars), rng.randint(*CLS_SENT_LEN)))
    rows = [{"id": start + i, "sentence1": sentence(),
             "sentence2": sentence()} for i in range(n)]
    if labelled:
        for r in rows:
            r["label"] = str(rng.randint(2))
    return rows


def cls_argv(workdir: Path, model_dir: Path, data_dir: Path,
             extra=()) -> list:
    """The AFQMC shell's flags (finetune_classification_bert-3.9B_afqmc.sh,
    less its FSDP degree), cut to CLS_STEPS steps."""
    return [str(x) for x in (
        "--pretrained_model_path", model_dir,
        "--model_type", "huggingface-megatron_bert",
        "--output_save_path", workdir / "predict.json",
        "--data_dir", data_dir, "--train_data", "train.json",
        "--valid_data", "dev.json", "--test_data", "test.json",
        "--train_batchsize", CLS_BATCH, "--valid_batchsize", 32,
        "--max_length", CLS_LEN, "--texta_name", "sentence1",
        "--textb_name", "sentence2", "--label_name", "label",
        "--id_name", "id", "--learning_rate", 1e-5,
        "--weight_decay", 1e-2, "--warmup", 0.01, "--num_labels", 2,
        "--monitor", "val_acc", "--mode", "max", "--save_top_k", 3,
        "--every_n_train_steps", 0, "--save_weights_only", "True",
        "--dirpath", workdir / "ckpt",
        "--filename", "model-{epoch:02d}-{val_acc:.4f}",
        "--max_epochs", 2, "--max_steps", CLS_STEPS,
        "--gradient_clip_val", 1.0, "--val_check_interval", CLS_VAL_EVERY,
        "--precision", "bf16", "--default_root_dir", workdir / "runs",
        "--log_every_n_steps", 1, "--seed", 0, "--device", "cuda",
        "--profile_steps", ",".join(map(str, CLS_PROFILE)), *extra)]


def kernel_launches() -> dict:
    from fengshen_tpu_torch.ops.kernels import _REGISTRY
    return {name: e.launches for name, e in _REGISTRY.items()}


def logits_of(model, batch, dtype: str, mask=True):
    """The classifier's fp32 logits with the compute dtype set to
    ``dtype`` (and the attention mask dropped when ``mask`` is
    false)."""
    import torch
    cfg = model.config
    before, cfg.dtype = cfg.dtype, dtype
    try:
        with torch.no_grad():
            logits = model(batch["input_ids"],
                           batch["attention_mask"] if mask else None,
                           batch["token_type_ids"])
        return logits.float()
    finally:
        cfg.dtype = before


def union_ms(intervals) -> float:
    """Milliseconds covered by the union of ``(start_us, end_us)``
    intervals: kernels that overlap (on two streams) count once."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def step_profile(trainer, profiled_steps) -> dict:
    """Device time per step of the steps a fit traced with
    ``--profile_steps`` (``trainer.profiler``, which starts and stops
    after a device sync, so the trace holds those steps' kernels and no
    others). Busy ms is the union of the kernels' intervals, and the
    idle share is 1 - busy / the steps' wall time; the summed kernel
    time, the streams and the span from the first kernel's start to the
    last one's end sit beside it. Also GEMM ms, kernels, ms per kernel
    group (CLS_PROFILE_GROUPS, summed kernel time) and the top
    kernels."""
    history = trainer.history
    from torch.autograd import DeviceType
    dev_us, n_kernels, spans, streams = {}, 0, [], set()
    for ev in trainer.profiler.events():
        # a GPU user annotation (the optimizer's step range) spans
        # kernels counted on their own
        if ev.device_type == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            n_kernels += 1
            dev_us[ev.name] = dev_us.get(ev.name, 0) + \
                ev.time_range.elapsed_us()
            spans.append((ev.time_range.start, ev.time_range.end))
            streams.add(ev.thread)
    n_prof = len(profiled_steps)
    walls = [e["step_time_s"] * 1e3 for e in history
             if "step_time_s" in e and e["step"] in profiled_steps]
    busy_ms = union_ms(spans) / n_prof
    sum_ms = sum(dev_us.values()) / 1e3 / n_prof
    idle = [1 - busy_ms / w for w in walls]
    gemm_ms = sum(us for name, us in dev_us.items() if any(
        k in name for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")))
    groups, top = {g: 0.0 for g, _ in CLS_PROFILE_GROUPS}, {}
    groups["other"] = 0.0
    for name, us in dev_us.items():
        group = next((g for g, keys in CLS_PROFILE_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] += us / 1e3 / n_prof
        top[name[:80]] = top.get(name[:80], 0.0) + us / 1e3 / n_prof
    profile = {
        "steps": sorted(profiled_steps),
        "wall_ms_per_step": walls,
        "device_busy_ms_per_step": busy_ms,
        "kernel_ms_summed_per_step": sum_ms,
        "device_span_ms": ((max(e for _, e in spans) -
                            min(s for s, _ in spans)) / 1e3
                           if spans else 0.0),
        "streams": len(streams),
        "device_idle_share": (idle if spans and min(idle) >= 0 else
                              "not measured: " + (
                                  "no device events" if not spans else
                                  f"busy {busy_ms} ms exceeds a wall time "
                                  f"of {walls} ms")),
        "gemm_ms_per_step": gemm_ms / 1e3 / n_prof,
        "kernels_per_step": n_kernels / n_prof,
        "group_ms_per_step": groups,
        "top_kernels_ms_per_step": dict(sorted(
            top.items(), key=lambda kv: -kv[1])[:8])}
    return profile


def phase_classification(workdir: Path, card):
    """``finetune_classification.main`` with the AFQMC shell's flags on
    Erlangshen-MegatronBert-1.3B at full width and all 24 layers (fp32
    weights made on the card from a seed, bf16 compute, dropout 0.1):
    CLS_STEPS steps of 8 x 128, validation every CLS_VAL_EVERY steps
    with checkpoints kept by ``val_acc``, then ``predict.json`` from the
    best one, which a ``--do_predict_only`` run must write again. On the
    best weights: the bf16 forward held to fp32 compute (the padding
    mask dropped must fail that bar), and a row's logits held across
    padding of 64 and 128. A 2-layer model at the same width written as
    an HF-named checkpoint and read back through
    ``load_torch_checkpoint`` gives bitwise logits, and the
    classification module imports its encoder. K1-K4 launch 0 times:
    the family runs the dense attention, as the reference does."""
    import shutil

    import numpy as np
    import torch
    from fengshen_tpu_torch.examples.classification import (
        finetune_classification as fc)
    from fengshen_tpu_torch.models.megatron_bert import (
        MegatronBertConfig, MegatronBertForSequenceClassification)
    from fengshen_tpu_torch.models.megatron_bert import convert
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.utils.convert_common import (
        load_torch_checkpoint)
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        committed_steps, read_meta)

    free = shutil.disk_usage(workdir).free / 2**30
    if free < CLS_MIN_FREE_GIB:
        raise AssertionError(f"classification: {free:.1f} GiB free under "
                             f"{workdir}, the phase needs "
                             f"{CLS_MIN_FREE_GIB}")
    t_phase = time.perf_counter()
    failures = []
    raw = json.loads(ERLANGSHEN_CONFIG.read_text())
    model_dir = workdir / "erlangshen"
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(raw))
    rng = np.random.RandomState(12)
    chars = "".join(chr(0x4E00 + i) for i in range(CLS_CHARS))
    tok = PairTokenizer(chars)
    data_dir = workdir / "afqmc"
    data_dir.mkdir(exist_ok=True)
    start, splits = 0, {}
    for split, labelled in (("train", True), ("dev", True),
                            ("test", False)):
        splits[split] = afqmc_rows(CLS_ROWS[split], chars, rng, labelled,
                                   start)
        write_jsonl(data_dir / f"{split}.json", splits[split])
        start += CLS_ROWS[split]
    labels = {r["label"] for r in splits["train"]}
    argv = cls_argv(workdir, model_dir, data_dir)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_fit = time.perf_counter()
    trainer = fc.main(argv, tokenizer=tok)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.history
    cb = next(c for c in trainer.callbacks if hasattr(c, "stats"))
    io = dict(cb.stats)
    n_params = next(e["n_params"] for e in history
                    if e.get("event") == "fit_start")
    flops_per_token = next(e["flops_per_token"] for e in history
                           if "flops_per_token" in e)
    losses = {e["step"]: e["loss"] for e in history if "loss" in e}
    vals = {e["step"]: e["val_acc"] for e in history if "val_acc" in e}
    profiled_steps = set(range(CLS_PROFILE[0] + 1, CLS_PROFILE[1] + 1))
    after_val = {s + 1 for s in vals} | profiled_steps
    step_s = sorted(e["step_time_s"] for e in history
                    if "step_time_s" in e and e["step"] >= 2 and
                    e["step"] not in after_val)
    profile = step_profile(trainer, profiled_steps)
    median_s = step_s[len(step_s) // 2]
    tokens = CLS_BATCH * CLS_LEN
    ckpt = workdir / "ckpt"
    kept = committed_steps(str(ckpt))
    ranked = sorted(vals, key=lambda s: (-vals[s], s))
    first = (workdir / "predict.json.0").read_text()
    rows = [json.loads(x) for x in first.splitlines()]
    test_ids = list(range(CLS_ROWS["train"] + CLS_ROWS["dev"], start))
    if len(losses) != CLS_STEPS or not np.isfinite(
            list(losses.values())).all():
        failures.append(f"losses {losses}")
    if sorted(vals) != list(range(CLS_VAL_EVERY, CLS_STEPS + 1,
                                  CLS_VAL_EVERY)):
        failures.append(f"validations at {sorted(vals)}")
    if kept != sorted(ranked[:3]) or any(
            read_meta(str(ckpt), s).get("monitor", {}).get("value")
            != vals[s] for s in kept):
        failures.append(f"kept {kept}, val_acc {vals}")
    if [r["id"] for r in rows] != test_ids or \
            not {r["label"] for r in rows} <= labels:
        failures.append(f"predict.json ids {[r['id'] for r in rows][:8]}"
                        f"..., labels {sorted({r['label'] for r in rows})}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # predict-only from the best checkpoint: the same file
    reset_launch_counts()
    again = fc.main(argv + ["--do_predict_only"], tokenizer=tok)
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    predict_only_equal = (workdir / "predict.json.0").read_text() == first
    if not predict_only_equal or again.global_step != ranked[0]:
        failures.append(f"--do_predict_only restored step "
                        f"{again.global_step} (best {ranked[0]}), file "
                        f"equal {predict_only_equal}")
    pcb = next(c for c in again.callbacks if hasattr(c, "stats"))
    io["restores"] += pcb.stats["restores"]
    io["bytes_read"] += pcb.stats["bytes_read"]
    io["restore_s"] += pcb.stats["restore_s"]
    model = again.state.model
    shutil.rmtree(ckpt)

    # bf16 against fp32 compute on the best weights, and the planted
    # fault: the padding mask dropped
    dm = fc.TaskDataModel(fc.build_parser().parse_args(argv),
                          tokenizer=tok)
    dev = {k: torch.as_tensor(v).cuda() for k, v in
           next(iter(dm.val_dataloader())).items()}
    reset_launch_counts()
    want = logits_of(model, dev, "float32")
    got = logits_of(model, dev, "bfloat16")
    no_mask = logits_of(model, dev, "bfloat16", mask=False)
    rel = ((got - want).norm() / want.norm()).item()
    rel_fault = ((no_mask - want).norm() / want.norm()).item()
    pad_share = 1.0 - dev["attention_mask"].float().mean().item()
    if rel > CLS_BF16_RTOL or rel_fault <= CLS_BF16_RTOL:
        failures.append(f"bf16 vs fp32 logits rel L2 {rel} (limit "
                        f"{CLS_BF16_RTOL}); mask dropped {rel_fault}")

    # a row's fp32 logits with its padding grown from 64 to 128
    short = fc.build_parser().parse_args(argv + ["--max_length", "64"])
    dm64 = fc.TaskDataModel(short, tokenizer=tok)
    rows8 = [dm64.valid_data[i] for i in range(8)]
    b64 = {k: torch.as_tensor(v).cuda()
           for k, v in dm64.collator(rows8).items()}
    b128 = {k: torch.as_tensor(v).cuda()
            for k, v in dm.collator(rows8).items()}
    same_tokens = bool((b128["input_ids"][:, :64] == b64["input_ids"]).all()
                       and not b128["attention_mask"][:, 64:].any())
    pad_diff = (logits_of(model, b64, "float32") -
                logits_of(model, b128, "float32")).abs().max().item()
    if not same_tokens or pad_diff > CLS_PAD_ATOL:
        failures.append(f"padding 64 -> 128 moved the fp32 logits by "
                        f"{pad_diff} (limit {CLS_PAD_ATOL}; rows fit 64: "
                        f"{same_tokens})")
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    del again, model, dev
    gc.collect()
    torch.cuda.empty_cache()

    # a 2-layer model at Erlangshen width through an HF-named checkpoint
    # (written by this script's own safetensors writer, read by the port's)
    cfg2 = MegatronBertConfig.from_pretrained(str(model_dir))
    cfg2.num_hidden_layers = CLS_CKPT_LAYERS
    src = MegatronBertForSequenceClassification(
        cfg2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(4))
    hf_dir = workdir / "hf2"
    hf_dir.mkdir()
    hf_state = convert.params_to_torch_state(src.state_dict(), cfg2)
    t0 = time.perf_counter()
    written = write_safetensors(hf_dir / "model.safetensors", hf_state)
    hf_write_s = time.perf_counter() - t0
    (hf_dir / "config.json").write_text(json.dumps(
        dict(raw, num_hidden_layers=CLS_CKPT_LAYERS)))
    t0 = time.perf_counter()
    loaded = load_torch_checkpoint(str(hf_dir))
    dst = MegatronBertForSequenceClassification(cfg2, device="cuda",
                                                init=False)
    dst.load_state_dict(convert.torch_to_params(
        loaded, cfg2, head="sequence_classification"))
    torch.cuda.synchronize()
    hf_read_s = time.perf_counter() - t0
    batch = {k: v[:8] for k, v in b128.items()}
    with torch.no_grad():
        ckpt_bitwise = all(torch.equal(
            src(batch["input_ids"], batch["attention_mask"],
                batch["token_type_ids"]),
            dst(batch["input_ids"], batch["attention_mask"],
                batch["token_type_ids"])) for _ in range(2))
    module = fc.ClassificationModule(fc.build_parser().parse_args(
        cls_argv(workdir, hf_dir, data_dir)), device="cuda")
    module.init_params(torch.Generator(device="cuda").manual_seed(0))
    imported = all(torch.equal(v, src.bert.state_dict()[k]) for k, v in
                   module.model.bert_encoder.state_dict().items())
    if not ckpt_bitwise or not imported:
        failures.append(f"2-layer HF checkpoint: logits bitwise "
                        f"{ckpt_bitwise}, encoder imported {imported}")
    del src, dst, module, loaded
    shutil.rmtree(hf_dir)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    if any(launches.values()):
        failures.append(f"kernel launches on the classification path: "
                        f"{launches}")
    tokens_per_s = tokens / median_s
    say("classification", card=card, config=ERLANGSHEN_CONFIG.name,
        n_params=n_params, steps=CLS_STEPS, batch=CLS_BATCH,
        max_length=CLS_LEN, fit_s=fit_s, step_time_s_median=median_s,
        step_time_s_range=[step_s[0], step_s[-1]],
        step1_s=next(e["step_time_s"] for e in history
                     if e.get("step") == 1 and "step_time_s" in e),
        samples_per_s=CLS_BATCH / median_s, tokens_per_s=tokens_per_s,
        flops_per_token=flops_per_token,
        mfu=flops_per_token * tokens_per_s / BF16_FLOPS,
        peak_gib=peak_gib, losses=losses, val_acc=vals, kept_steps=kept,
        best_step=ranked[0], predict_rows=len(rows),
        predict_only_equal=predict_only_equal,
        bf16_vs_fp32_rel_l2=rel, mask_dropped_rel_l2=rel_fault,
        dev_pad_share=pad_share, pad_64_128_max_abs=pad_diff,
        hf_ckpt_bitwise=ckpt_bitwise, hf_ckpt_encoder_imported=imported,
        hf_ckpt_gib=written / 2**30,
        hf_ckpt_write_gib_per_s=written / 2**30 / max(hf_write_s, 1e-9),
        hf_ckpt_read_gib_per_s=written / 2**30 / max(hf_read_s, 1e-9),
        ckpt_saves=io["saves"], ckpt_gib_written=io["bytes_written"] / 2**30,
        ckpt_write_gib_per_s=io["bytes_written"] / 2**30 /
        max(io["save_s"], 1e-9),
        ckpt_gib_read=io["bytes_read"] / 2**30,
        ckpt_read_gib_per_s=io["bytes_read"] / 2**30 /
        max(io["restore_s"], 1e-9),
        profile=profile, kernel_launches=launches,
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("classification: " + "; ".join(failures))


# -- phase 13 -----------------------------------------------------------

#: Wenzhong phase (13): Wenzhong-GPT2-3.5B at its published geometry
#: (all 30 blocks at width 3072), fine-tuned with the flags of the
#: reference's medicalQA shell (finetune_GPT2_medicalQA.sh: batch 1 x
#: 512, lr 1e-5, weight decay 0.01, beta2 0.95, clip 1.0) for WZ_STEPS
#: steps over one repeated record and validated once
WENZHONG_CONFIG = ROOT / "configs" / "wenzhong_gpt2_3.5b.json"
WZ_STEPS, WZ_SEQ = 8, 512
#: free device memory the phase needs: fp32 weights, grads and two
#: AdamW moments of 3.56e9 parameters take 53.0 GiB, AdamW's foreach
#: temporaries another 13.2 GiB at the update
WZ_MIN_FREE_GIB = 70
#: free disk under TMPDIR: a 2-layer checkpoint with its moments (4.6
#: GB) and a 2-layer HF export (1.5 GB)
WZ_MIN_DISK_GIB = 12
#: the steps traced with torch.profiler (steps 5 and 6)
WZ_PROFILE = (4, 6)
#: fused_ce_chunks of the K2 run
WZ_CE_CHUNKS = 8
#: step 1 through K2 against step 1 with the materialised logits (same
#: weights, batch and dropout masks): the logits path rounds the [511,
#: 50304] scores to bf16 (an ulp of 2^-6 at |s| ~ 4) where K2 keeps fp32,
#: which moves a 511-token mean of lse - gold by ~1e-3; the loss within
#: 2e-2, the global grad norm within 5e-2 relative
WZ_LOSS_ATOL = 2e-2
WZ_GRAD_NORM_RTOL = 5e-2
#: the 30-block forward in bf16 against fp32 compute on one 1 x 128 row:
#: ||logits_bf16 - logits_fp32|| / ||logits_fp32||, as phase 12's bar
WZ_BF16_RTOL = 1e-1
WZ_BF16_ROW = 128
#: greedy tokens decoded over GPT-2's cache through yuyuan_qa.answer
WZ_NEW_TOKENS = 32
#: the round trips' depth (full width), and its fine-tune's steps
WZ_CKPT_LAYERS, WZ_RESUME_STEPS = 2, 3


def qa_record(rng, vocab: int, n_question: int = 100,
              n_answer: int = 440) -> dict:
    """A medicalQA-shaped record for the IdTokenizer (ids as text): the
    question, ``"Question:"`` and ``" Answer:"`` encode to 117 tokens,
    so the answer fills the row of WZ_SEQ and is cut there."""
    def ids(k):
        return " ".join(map(str, rng.randint(3, vocab, k)))
    return {"question": ids(n_question), "answer": ids(n_answer)}


def wenzhong_argv(root: Path, model_dir: Path, train: Path, steps: int,
                  extra=()) -> list:
    """The medicalQA shell's flags (finetune_GPT2_medicalQA.sh), cut to
    ``steps`` steps."""
    return [str(x) for x in (
        "--model_path", model_dir, "--train_file", train,
        "--default_root_dir", root, "--train_batchsize", 1,
        "--max_seq_length", WZ_SEQ, "--learning_rate", 1e-5,
        "--weight_decay", 0.01, "--adam_beta2", 0.95,
        "--gradient_clip_val", 1.0, "--precision", "bf16",
        "--max_steps", steps, "--log_every_n_steps", 1, "--seed", 0,
        "--device", "cuda", *extra)]


def config_dir(path: Path, raw: dict) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(raw))
    return path


def phase_wenzhong(workdir: Path, card):
    """Wenzhong-GPT2-3.5B at full width and all 30 blocks (fp32 weights
    made on the card from a seed, bf16 compute, per-block
    checkpointing): ``finetune_wenzhong.main`` with the medicalQA
    shell's flags for WZ_STEPS steps of 1 x 512 over one repeated
    record and one validation (steps 5-6 profiled); the same step once
    more with ``fused_ce_chunks`` 8, through K2 under the tied head,
    held to the materialised-logits step; K2 against its plain version
    at that shape; the bf16 forward held to fp32 compute; 32 tokens of
    ``yuyuan_qa.answer`` decoded over GPT-2's cache, held to one uncached
    forward; then at 2 blocks an HF-named export answered by
    ``yuyuan_qa.main`` from a piped stdin, and a fine-tune preempted by
    a real SIGTERM after step 2 (the Trainer saves) and resumed, whose
    step 3 equals the uninterrupted run's bitwise.
    Only the K2 run launches kernels (K2's three, once each). Returns
    ``(K2 launches, K2 rows at Wenzhong's shape)``."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch
    from fengshen_tpu_torch.examples.fastdemo import yuyuan_qa
    from fengshen_tpu_torch.examples.wenzhong_qa import (
        finetune_wenzhong as fw)
    from fengshen_tpu_torch.models.gpt2 import (GPT2Config,
                                                GPT2LMHeadModel, convert)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.pipelines.text_generation import IdTokenizer
    from fengshen_tpu_torch.resilience import FaultPlan

    gc.collect()
    torch.cuda.empty_cache()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    if free_gib < WZ_MIN_FREE_GIB:
        raise AssertionError(f"wenzhong: {free_gib:.2f} GiB free on the "
                             f"card, the phase needs {WZ_MIN_FREE_GIB}")
    disk_gib = shutil.disk_usage(workdir).free / 2**30
    if disk_gib < WZ_MIN_DISK_GIB:
        raise AssertionError(f"wenzhong: {disk_gib:.1f} GiB free under "
                             f"{workdir}, the phase needs "
                             f"{WZ_MIN_DISK_GIB}")
    t_phase = time.perf_counter()
    failures = []
    raw = json.loads(WENZHONG_CONFIG.read_text())
    vocab = raw["vocab_size"]
    model_dir = config_dir(workdir / "wenzhong", raw)
    rng = np.random.RandomState(13)
    train = write_jsonl(workdir / "wz_train.jsonl",
                        [qa_record(rng, vocab)] * WZ_STEPS)
    val = write_jsonl(workdir / "wz_val.jsonl", [qa_record(rng, vocab)])
    tok = IdTokenizer()

    # 1. the medicalQA shell's fine-tune at full depth
    argv = wenzhong_argv(workdir / "wz_runs", model_dir, train, WZ_STEPS, (
        "--val_file", val, "--val_batchsize", 1, "--profile_steps",
        ",".join(map(str, WZ_PROFILE)),
        *no_checkpoints(workdir / "wz_ckpt")))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = fw.main(argv, tokenizer=tok)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.history
    steps = [e for e in history if "loss" in e]
    vals = [e["val_loss"] for e in history if "val_loss" in e]
    losses = [e["loss"] for e in steps]
    n_params = next(e["n_params"] for e in history
                    if e.get("event") == "fit_start")
    flops_per_token = steps[-1]["flops_per_token"]
    profiled = set(range(WZ_PROFILE[0] + 1, WZ_PROFILE[1] + 1))
    # steady steps: not step 1, not the traced ones, and not the one
    # after them, which stops the trace and writes it out
    step_s = sorted(e["step_time_s"] for e in steps
                    if e["step"] >= 2 and e["step"] not in profiled and
                    e["step"] != WZ_PROFILE[1] + 1)
    median_s = step_s[len(step_s) // 2]
    profile = step_profile(trainer, profiled)
    ce_step1 = steps[0]
    if len(steps) != WZ_STEPS or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        failures.append(f"losses {losses} (finite, falling on the "
                        f"repeated record)")
    if len(vals) != 1 or not np.isfinite(vals).all():
        failures.append(f"validation losses {vals}")
    if any(fit_launches.values()):
        failures.append(f"kernel launches in the CE fit: {fit_launches}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 2. step 1 again with fused_ce_chunks 8: K2 under the tied head
    k2_dir = config_dir(workdir / "wenzhong_k2",
                        dict(raw, fused_ce_chunks=WZ_CE_CHUNKS))
    reset_launch_counts()
    trainer = fw.main(wenzhong_argv(
        workdir / "wz_k2_runs", k2_dir, train, 1,
        no_checkpoints(workdir / "wz_ckpt")), tokenizer=tok)
    torch.cuda.synchronize()
    all_launches = kernel_launches()
    k2_launches = {n: all_launches.pop(n) for n in K2_NAMES}
    k2_step1 = next(e for e in trainer.history if "loss" in e)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    loss_gap = abs(k2_step1["loss"] - ce_step1["loss"])
    norm_rel = abs(k2_step1["grad_norm"] - ce_step1["grad_norm"]) / \
        abs(ce_step1["grad_norm"])
    chunks = -(-(WZ_SEQ - 1) // 1024)
    if k2_launches != {"fused_ce_fwd": 1, "fused_ce_bwd_dx": chunks,
                       "fused_ce_bwd_dk": chunks} or any(
            all_launches.values()):
        failures.append(f"K2 run launches {k2_launches}, others "
                        f"{all_launches}")
    if loss_gap > WZ_LOSS_ATOL or norm_rel > WZ_GRAD_NORM_RTOL:
        failures.append(f"step 1 through K2 (loss {k2_step1['loss']}, "
                        f"grad norm {k2_step1['grad_norm']}) against the "
                        f"logits (loss {ce_step1['loss']}, grad norm "
                        f"{ce_step1['grad_norm']})")

    # 3. K2 against its plain version at this path's shape
    k2_rows = phase_ce_kernels(WZ_SEQ - 1, raw["n_embd"], vocab,
                               label="fused_ce_wenzhong", seed=13)

    # 4. numerics at depth 30: bf16 against fp32 compute, and greedy
    # decode over the cache against one uncached forward
    cfg = GPT2Config.from_pretrained(str(model_dir))
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    row = torch.as_tensor(rng.randint(3, vocab, (1, WZ_BF16_ROW)),
                          device="cuda")
    reset_launch_counts()
    with torch.no_grad():
        got = model(row).float()
        cfg.dtype = "float32"
        want = model(row).float()
        cfg.dtype = "bfloat16"
    bf16_rel = ((got - want).norm() / want.norm()).item()
    del got, want
    if bf16_rel > WZ_BF16_RTOL:
        failures.append(f"bf16 vs fp32 logits rel L2 {bf16_rel} (limit "
                        f"{WZ_BF16_RTOL})")
    question = " ".join(map(str, rng.randint(3, vocab, 40)))
    prompt = tok.encode(f"Question:{question} Answer:",
                        add_special_tokens=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = yuyuan_qa.answer(model, tok, question,
                            max_new_tokens=WZ_NEW_TOKENS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    tokens = [int(t) for t in text.split()]
    with torch.no_grad():
        seq = torch.tensor([prompt + tokens[:-1]], device="cuda")
        pred = model(seq).float()[0, len(prompt) - 1:]
    chosen = torch.tensor(tokens, device="cuda")
    worst_gap = (pred.max(-1).values -
                 pred.gather(1, chosen[:, None])[:, 0]).max().item()
    argmax = pred.argmax(-1).tolist()
    first = next((i for i, (a, b) in enumerate(zip(argmax, tokens))
                  if a != b), None)
    first_gap = None
    if first is not None:
        top = pred[first].topk(2).values
        first_gap = (top[0] - top[1]).item()
    decode_launches = kernel_launches()
    if len(tokens) != WZ_NEW_TOKENS or worst_gap > TF_MARGIN or \
            (first is not None and first_gap > TF_MARGIN) or \
            any(decode_launches.values()):
        failures.append(f"cached decode {len(tokens)} tokens, first "
                        f"disagreement {first} (top-2 gap {first_gap}), "
                        f"worst gap {worst_gap} (margin {TF_MARGIN}), "
                        f"launches {decode_launches}")
    del model, pred, seq
    gc.collect()
    torch.cuda.empty_cache()

    # 5. round trips at 2 blocks, full width: an HF-named export that
    # yuyuan_qa.main serves from a piped stdin, and a resumed fine-tune
    raw2 = dict(raw, n_layer=WZ_CKPT_LAYERS)
    cfg2 = GPT2Config(**{k: v for k, v in raw2.items()
                         if not k.startswith("_") and k != "model_type"})
    src = GPT2LMHeadModel(cfg2, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(4))
    hf_dir = config_dir(workdir / "wz_hf2", raw2)
    t0 = time.perf_counter()
    exported = write_safetensors(
        hf_dir / "model.safetensors",
        convert.params_to_torch_state(src.state_dict(), cfg2))
    export_s = time.perf_counter() - t0
    want_answer = yuyuan_qa.answer(src, tok, question, max_new_tokens=16)
    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(sys, "stdin", io.StringIO(question + "\n\n")), \
            contextlib.redirect_stdout(out):
        yuyuan_qa.main(["--model_path", str(hf_dir), "--max_new_tokens",
                        "16", "--device", "cuda"], tokenizer=tok)
    demo_s = time.perf_counter() - t0
    demo_lines = out.getvalue().splitlines()
    if demo_lines[1:] != [want_answer]:
        failures.append(f"yuyuan_qa.main answered {demo_lines[1:]}, the "
                        f"exported model {want_answer!r}")
    del src
    shutil.rmtree(hf_dir)
    gc.collect()
    torch.cuda.empty_cache()
    small_dir = config_dir(workdir / "wenzhong2", raw2)
    ck = workdir / "wz_ckpt2"
    ck_flags = ("--save_ckpt_path", ck, "--load_ckpt_path", ck,
                "--every_n_train_steps", 10 ** 9)

    def fit(name, flags, install=None):
        argv = wenzhong_argv(workdir / name, small_dir, train,
                             WZ_RESUME_STEPS, flags)
        with fit_hook(install or (lambda trainer, module: None)):
            trainer = fw.main(argv, tokenizer=tok)
        got = {e["step"]: e["loss"] for e in trainer.history
               if "loss" in e}
        stats = next(c for c in trainer.callbacks
                     if hasattr(c, "stats")).stats
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return got, dict(stats)

    reset_launch_counts()
    whole, _ = fit("wz_whole", no_checkpoints(workdir / "wz_none"))
    # a real SIGTERM after step 2: the Trainer saves, returns, resumes
    first_run, saved = fit("wz_first", ck_flags, lambda trainer, module:
                           FaultPlan(sigterm_at_step=2).install(trainer))
    resumed, restored = fit("wz_resumed", ck_flags)
    round_launches = kernel_launches()
    if first_run != {s: whole[s] for s in (1, 2)} or \
            resumed != {3: whole[3]} or saved["saves"] != 1 or \
            restored["restores"] != 1:
        failures.append(f"resume: uninterrupted {whole}, saved {first_run}"
                        f", resumed {resumed}")
    if any(round_launches.values()):
        failures.append(f"kernel launches at 2 blocks: {round_launches}")
    shutil.rmtree(ck)
    tokens_per_s = WZ_SEQ / median_s
    say("wenzhong", card=card, config=WENZHONG_CONFIG.name,
        n_params=n_params, free_gib_at_start=free_gib, steps=WZ_STEPS,
        seq=WZ_SEQ, fit_s=fit_s, step1_s=ce_step1["step_time_s"],
        step_time_s_median=median_s,
        step_time_s_range=[step_s[0], step_s[-1]],
        step_s=[e["step_time_s"] for e in steps],
        tokens_per_s=tokens_per_s, flops_per_token=flops_per_token,
        mfu=flops_per_token * tokens_per_s / BF16_FLOPS,
        max_memory_allocated_gib=peak_gib, losses=losses,
        grad_norms=[e["grad_norm"] for e in steps], val_losses=vals,
        profile=profile, fit_launches=fit_launches,
        k2_launches=k2_launches, k2_step1_loss=k2_step1["loss"],
        ce_step1_loss=ce_step1["loss"], loss_gap=loss_gap,
        loss_atol=WZ_LOSS_ATOL, k2_step1_grad_norm=k2_step1["grad_norm"],
        ce_step1_grad_norm=ce_step1["grad_norm"], grad_norm_rel=norm_rel,
        grad_norm_rtol=WZ_GRAD_NORM_RTOL, k2_step1_s=k2_step1[
            "step_time_s"], bf16_vs_fp32_rel_l2=bf16_rel,
        bf16_rtol=WZ_BF16_RTOL, decode_tokens=len(tokens),
        decode_ms_per_token=decode_s / max(len(tokens), 1) * 1e3,
        decode_exact_argmax=sum(a == b for a, b in zip(argmax, tokens)),
        decode_first_disagreement=first, decode_first_gap=first_gap,
        decode_worst_gap=worst_gap, tf_margin=TF_MARGIN,
        export_gib=exported / 2**30,
        export_write_gib_per_s=exported / 2**30 / max(export_s, 1e-9),
        demo_s=demo_s, demo_answer_equal=demo_lines[1:] == [want_answer],
        resume_losses={"whole": whole, "first": first_run,
                       "resumed": resumed},
        ckpt_gib_written=saved["bytes_written"] / 2**30,
        ckpt_write_gib_per_s=saved["bytes_written"] / 2**30 /
        max(saved["save_s"], 1e-9),
        ckpt_gib_read=restored["bytes_read"] / 2**30,
        ckpt_read_gib_per_s=restored["bytes_read"] / 2**30 /
        max(restored["restore_s"], 1e-9),
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("wenzhong: " + "; ".join(failures))
    return k2_launches, k2_rows


# -- phase 14 -----------------------------------------------------------

#: Randeng summarization phase (14): Randeng-T5-784M at its published
#: geometry (24 + 24 layers at width 1024, untied 32596-token head),
#: fine-tuned with the flags of the reference's 784M summary shell
#: (randeng_t5_784M_summary.sh: batch 64, encoder 128, decoder 64 tokens,
#: lr 1e-4, weight decay 1e-2, val_loss checkpoints, bf16) on LCSTS-shaped
#: records made from a seed: RD_TRAIN distinct records cycled over
#: RD_STEPS steps (the shell's one epoch of LCSTS is ~37k steps),
#: validation every RD_VAL_EVERY steps, the test split decoded
RANDENG_CONFIG = ROOT / "configs" / "randeng_t5_784m.json"
RD_PARAMS = 784_108_544
RD_TRAIN, RD_VAL, RD_TEST = 64, 64, 128
RD_STEPS, RD_VAL_EVERY, RD_BATCH, RD_ENC, RD_DEC = 20, 10, 64, 128, 64
#: LCSTS-shaped records: a text of 80-128 characters and a summary of
#: 10-30 characters taken from it, over RD_CHARS CJK characters
RD_CHARS, RD_TEXT_LEN, RD_SUMMARY_LEN = 3000, (80, 129), (10, 31)
#: free disk under TMPDIR: two val_loss checkpoints of fp32 weights and
#: both AdamW moments (9.4 GB each) and a 2-layer HF export (0.4 GB)
RD_MIN_DISK_GIB = 24
#: the steps traced with torch.profiler (steps 5 and 6)
RD_PROFILE = (4, 6)
#: the 48-layer forward in bf16 against fp32 compute on one batch:
#: ||logits_bf16 - logits_fp32|| / ||logits_fp32|| (Erlangshen measured
#: 2.8e-3 against 2e-2, Wenzhong 1.6e-2 against 1e-1). The batch is the
#: RD_BF16_ROWS test rows with the most padding (about a third of their
#: encoder tokens), so the planted fault (the encoder padding mask
#: dropped, every query attending to the pads) has pads to attend to
RD_BF16_RTOL = 5e-2
RD_BF16_ROWS = 16
#: rows of the cached greedy and beam checks, and the beam width
RD_TF_ROWS, RD_BEAMS = 8, 4
#: the cached-greedy bar: each token within TF_MARGIN of the uncached
#: forward's argmax, or within RD_TIE_ULPS bf16 ulps of the argmax logit.
#: TF_MARGIN was set for Ziya's logits of order 10 (an ulp of 1/16);
#: Randeng's untied random head (N(0, 1), the reference's init) puts
#: the top logit near 4 x sqrt(1024) ~ 130, where one bf16 ulp is 1.0,
#: and the cached and uncached decoders round differently (a sound H100
#: run parted by at most 2 ulps, PERF.md §6). A cache fault (a wrong
#: position bias or cross K/V) moves a token by tens of logits: a
#: random model decoded chaotically parted by 64-75
RD_TIE_ULPS = 4
#: beam 4 re-scored by one uncached forward against greedy re-scored by
#: the same forward: mean log-probability per generated token (length
#: penalty 1.0, as the beam scores), beam no lower than greedy less this
#: margin: one decision on a near-tie moves a token's log-probability by
#: up to RD_TIE_ULPS ulps (2 nats at the top logit) between the cached
#: logits the beam chose on and the uncached ones, spread over >= 8
#: tokens of a row
RD_BEAM_MARGIN = 0.25
RD_CKPT_LAYERS = 2
#: greedy decode steps traced with torch.profiler at batch 64
RD_PROF_NEW = 8


def profile_decode(run, steps: int) -> dict:
    """Wall time, device busy time and kernels per decode step of one
    ``run()`` (a decode of ``steps`` tokens) under ``torch.profiler``,
    and the busy time by kernel group (CLS_PROFILE_GROUPS)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernels = 0.0, 0
    groups = {g: 0.0 for g, _ in CLS_PROFILE_GROUPS}
    groups["other"] = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            us = ev.time_range.elapsed_us()
            busy_us += us
            kernels += 1
            group = next((g for g, keys in CLS_PROFILE_GROUPS
                          if any(k in ev.name for k in keys)), "other")
            groups[group] += us / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
            "kernels_per_step": kernels / steps,
            "group_ms_per_step": groups}


class CharTokenizer:
    """A character-level tokenizer with the surface ``Seq2SeqCollator``
    and ``evaluate_and_save`` use (``encode``, ``batch_decode``,
    ``pad_token_id``, ``eos_token_id``): pad 0, eos 1, unk 2, then the
    phase's own characters (the card's machine has no Randeng
    vocabulary)."""

    pad_token_id, eos_token_id, unk_id = 0, 1, 2

    def __init__(self, chars: str):
        self.vocab = {c: i + 3 for i, c in enumerate(chars)}
        self.chars = {i: c for c, i in self.vocab.items()}

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        return [self.vocab.get(c, self.unk_id) for c in text]

    def batch_decode(self, rows, skip_special_tokens=False):
        return ["".join(self.chars.get(int(i), "" if skip_special_tokens
                                       else f"<{int(i)}>") for i in row)
                for row in rows]


def lcsts_rows(n: int, chars: str, rng) -> list:
    out = []
    for _ in range(n):
        text = "".join(rng.choice(list(chars), rng.randint(*RD_TEXT_LEN)))
        k = rng.randint(*RD_SUMMARY_LEN)
        start = rng.randint(0, len(text) - k + 1)
        out.append({"text": text, "summary": text[start:start + k]})
    return out


def randeng_argv(workdir: Path, model_dir: Path, data: dict,
                 extra=()) -> list:
    """The 784M summary shell's flags (randeng_t5_784M_summary.sh) with
    local files for ``--datasets_name lcsts``, cut to RD_STEPS steps."""
    return [str(x) for x in (
        "--model_type", "t5", "--pretrained_model_path", model_dir,
        "--output_save_path", workdir / "predict.json",
        "--train_file", data["train"], "--val_file", data["val"],
        "--test_file", data["test"], "--default_root_dir", workdir / "runs",
        "--save_ckpt_path", workdir / "ckpt",
        "--load_ckpt_path", workdir / "ckpt", "--monitor", "val_loss",
        "--mode", "min", "--save_top_k", 3, "--save_last",
        "--train_batchsize", RD_BATCH, "--val_batchsize", RD_BATCH,
        "--test_batchsize", RD_BATCH, "--max_enc_length", RD_ENC,
        "--max_dec_length", RD_DEC, "--prompt", "", "--learning_rate", 1e-4,
        "--weight_decay", 1e-2, "--max_epochs", RD_STEPS, "--max_steps",
        RD_STEPS, "--val_check_interval", RD_VAL_EVERY, "--precision",
        "bf16", "--log_every_n_steps", 1, "--seed", 0, "--device", "cuda",
        *extra)]


def mean_logprob(logp, tokens, eos: int, horizon: int) -> list:
    """Per row: the mean log-probability of the generated tokens (up to
    and including the first eos, else to the horizon) under ``logp [B,
    T, V]`` of the uncached forward over ``tokens[:, :-1]``: the beam's
    own score at length penalty 1.0."""
    out = []
    for b in range(tokens.shape[0]):
        row = tokens[b, 1:].tolist()
        t = row.index(eos) + 1 if eos in row else horizon
        out.append(float(logp[b, :t].gather(
            1, tokens[b, 1:t + 1, None])[:, 0].sum()) / t)
    return out


def phase_randeng(workdir: Path, card):
    """``seq2seq_summary.main`` with the 784M summary shell's flags on
    Randeng-T5-784M at full width and depth (fp32 weights made on the
    card from a seed, bf16 compute, dropout 0.1): RD_STEPS steps of 64 x
    (128 + 64), validation every RD_VAL_EVERY steps with checkpoints kept
    by ``val_loss``, then greedy ``predict.json`` over the RD_TEST test
    records from the best one, with ROUGE. ``--do_eval_only`` with beam
    4 writes its own file, and with ``--num_beams 1`` the fit's again,
    byte for byte. On those weights: the bf16 forward held to fp32
    compute (the encoder padding mask dropped must fail that bar);
    RD_TF_ROWS rows of cached greedy decode held to one uncached forward,
    and their beam-4 outputs, re-scored by it, no worse than greedy's.
    A 2-layer model at that width written as an HF-named checkpoint and
    read back through ``load_hf_pretrained`` gives bitwise logits. K1-K4
    launch 0 times: T5 computes its own attention with a position bias,
    as the reference does."""
    import shutil

    import numpy as np
    import torch
    from fengshen_tpu_torch.examples.summary import seq2seq_summary as ss
    from fengshen_tpu_torch.models.t5 import (T5Config,
                                              T5ForConditionalGeneration)
    from fengshen_tpu_torch.models.t5 import convert
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.utils.generate import seq2seq_generate
    from fengshen_tpu_torch.utils.universal_checkpoint import (
        committed_steps)

    free = shutil.disk_usage(workdir).free / 2**30
    if free < RD_MIN_DISK_GIB:
        raise AssertionError(f"randeng: {free:.1f} GiB free under "
                             f"{workdir}, the phase needs {RD_MIN_DISK_GIB}")
    t_phase = time.perf_counter()
    failures = []
    raw = json.loads(RANDENG_CONFIG.read_text())
    cfg = T5Config.from_pretrained(str(RANDENG_CONFIG))
    with torch.device("meta"):
        n_params = sum(p.numel() for p in T5ForConditionalGeneration(
            cfg, device="meta").parameters())
    if n_params != RD_PARAMS or (cfg.num_layers, cfg.num_decoder_layers) \
            != (24, 24):
        raise AssertionError(f"randeng: {n_params} parameters, "
                             f"{cfg.num_layers} + {cfg.num_decoder_layers} "
                             f"layers (want {RD_PARAMS}, 24 + 24)")
    model_dir = config_dir(workdir / "randeng", raw)
    rng = np.random.RandomState(14)
    chars = "".join(chr(0x4E00 + i) for i in range(RD_CHARS))
    tok = CharTokenizer(chars)
    data, splits = {}, {}
    for split, n in (("train", RD_TRAIN), ("val", RD_VAL),
                     ("test", RD_TEST)):
        splits[split] = lcsts_rows(n, chars, rng)
        data[split] = write_jsonl(workdir / f"lcsts_{split}.json",
                                  splits[split])
    argv = randeng_argv(workdir, model_dir, data, (
        "--profile_steps", ",".join(map(str, RD_PROFILE))))

    # 1. the shell's fine-tune, then greedy predict.json from the best
    # val_loss checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = ss.main(argv, tokenizer=tok)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.history
    cb = next(c for c in trainer.callbacks if hasattr(c, "stats"))
    io = dict(cb.stats)
    steps = [e for e in history if "loss" in e]
    losses = [e["loss"] for e in steps]
    vals = {e["step"]: e["val_loss"] for e in history if "val_loss" in e}
    rouge = next(e for e in history if e.get("event") == "rouge")
    flops_per_token = steps[-1]["flops_per_token"]
    profiled = set(range(RD_PROFILE[0] + 1, RD_PROFILE[1] + 1))
    skip = profiled | {RD_PROFILE[1] + 1} | {s + 1 for s in vals}
    step_s = sorted(e["step_time_s"] for e in steps
                    if e["step"] >= 2 and e["step"] not in skip)
    median_s = step_s[len(step_s) // 2]
    profile = step_profile(trainer, profiled)
    kept = committed_steps(str(workdir / "ckpt"))
    best = min(vals, key=lambda s: (vals[s], s)) if vals else None
    greedy_file = (workdir / "predict.json").read_text()
    pred_rows = len(greedy_file.splitlines())
    if len(losses) != RD_STEPS or not np.isfinite(losses).all():
        failures.append(f"losses {losses}")
    if sorted(vals) != list(range(RD_VAL_EVERY, RD_STEPS + 1,
                                  RD_VAL_EVERY)) or \
            not np.isfinite(list(vals.values())).all():
        failures.append(f"validations {vals}")
    if kept != sorted(vals) or trainer.global_step != best:
        failures.append(f"kept {kept}, predicted from step "
                        f"{trainer.global_step} (best {best})")
    if pred_rows != RD_TEST or rouge["rows"] != RD_TEST:
        failures.append(f"predict.json {pred_rows} rows, ROUGE over "
                        f"{rouge['rows']} (want {RD_TEST})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 2. --do_eval_only from the saved checkpoints: beam 4, then greedy
    # (the fit's file again, byte for byte)
    eval_only = argv[:argv.index("--profile_steps")] + ["--do_eval_only"]
    reset_launch_counts()
    t0 = time.perf_counter()
    beam_run = ss.main(eval_only + ["--num_beams", str(RD_BEAMS),
                                    "--output_save_path",
                                    str(workdir / "predict_beam.json")],
                       tokenizer=tok)
    torch.cuda.synchronize()
    beam_eval_s = time.perf_counter() - t0
    eval_io = [next(c for c in beam_run.callbacks
                    if hasattr(c, "stats")).stats]
    del beam_run
    gc.collect()
    torch.cuda.empty_cache()
    beam_rows = len((workdir / "predict_beam.json").read_text()
                    .splitlines())
    t0 = time.perf_counter()
    again = ss.main(eval_only + ["--num_beams", "1"], tokenizer=tok)
    torch.cuda.synchronize()
    greedy_eval_s = time.perf_counter() - t0
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    eval_equal = (workdir / "predict.json").read_text() == greedy_file
    if not eval_equal or beam_rows != RD_TEST or again.global_step != best:
        failures.append(f"--do_eval_only: greedy file equal {eval_equal}, "
                        f"beam rows {beam_rows}, restored step "
                        f"{again.global_step} (best {best})")
    model = again.state.model
    model.requires_grad_(False)
    eval_io.append(next(c for c in again.callbacks
                        if hasattr(c, "stats")).stats)
    for stats in eval_io:
        for key in ("restores", "bytes_read", "restore_s"):
            io[key] += stats[key]
    del again
    shutil.rmtree(workdir / "ckpt")

    # 3. numerics on those weights
    collator = ss.Seq2SeqCollator(tok, max_src_length=RD_ENC,
                                  max_tgt_length=RD_DEC)
    test = collator(splits["test"])
    by_pad = np.argsort(test["attention_mask"].sum(1), kind="stable")
    rows = by_pad[:RD_BF16_ROWS]
    batch = {k: torch.as_tensor(v[rows]).to("cuda") for k, v in test.items()}
    reset_launch_counts()

    def logits(dtype, mask=True):
        before, model.config.dtype = model.config.dtype, dtype
        try:
            with torch.no_grad():
                return model(batch["input_ids"], batch["decoder_input_ids"],
                             attention_mask=batch["attention_mask"]
                             if mask else None).float()
        finally:
            model.config.dtype = before

    want = logits("float32")
    rel = ((logits("bfloat16") - want).norm() / want.norm()).item()
    rel_fault = ((logits("bfloat16", mask=False) - want).norm() /
                 want.norm()).item()
    pad_share = 1.0 - batch["attention_mask"].float().mean().item()
    if rel > RD_BF16_RTOL or rel_fault <= RD_BF16_RTOL:
        failures.append(f"bf16 vs fp32 logits rel L2 {rel} (limit "
                        f"{RD_BF16_RTOL}); encoder mask dropped "
                        f"{rel_fault}")
    del want

    # cached greedy and beam 4 on RD_TF_ROWS rows, re-scored by one
    # uncached forward; then each decode timed at batch 64
    ids = torch.as_tensor(test["input_ids"][:RD_TF_ROWS]).to("cuda")
    mask = torch.as_tensor(test["attention_mask"][:RD_TF_ROWS]).to("cuda")
    common = dict(max_new_tokens=RD_DEC, decoder_start_token_id=0,
                  eos_token_id=1, pad_token_id=0, device="cuda")
    greedy = seq2seq_generate(model, ids, mask, **common)
    beam = seq2seq_generate(model, ids, mask, num_beams=RD_BEAMS, **common)
    worst_gap = worst_ulps = 0.0
    exact = total = 0
    scores = {}
    for name, out in (("greedy", greedy), ("beam", beam)):
        with torch.no_grad():
            pred = model(ids, out[:, :-1], attention_mask=mask).float()
        logp = torch.log_softmax(pred, -1)
        scores[name] = mean_logprob(logp, out, 1, RD_DEC)
        if name != "greedy":
            continue
        for b in range(RD_TF_ROWS):
            row = out[b, 1:].tolist()
            t = row.index(1) + 1 if 1 in row else RD_DEC
            top = pred[b, :t].max(-1).values
            chosen = pred[b, :t].gather(1, out[b, 1:t + 1, None])[:, 0]
            gap = top - chosen
            # one bf16 ulp at the argmax logit: 2^(exponent - 7)
            ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
            worst_gap = max(worst_gap, gap.max().item())
            worst_ulps = max(worst_ulps, (gap / ulp).max().item())
            bad = (gap > TF_MARGIN) & (gap > RD_TIE_ULPS * ulp)
            if bad.any():
                failures.append(f"cached greedy row {b}: a token "
                                f"{gap[bad].max().item()} below the "
                                f"uncached argmax")
            exact += int((gap == 0).sum())
            total += t
    beam_minus_greedy = [s - g for s, g in zip(scores["beam"],
                                               scores["greedy"])]
    if min(beam_minus_greedy) < -RD_BEAM_MARGIN:
        failures.append(f"beam {RD_BEAMS} re-scored below greedy: "
                        f"{beam_minus_greedy} (margin {RD_BEAM_MARGIN})")
    ids64 = torch.as_tensor(test["input_ids"][:RD_BATCH]).to("cuda")
    mask64 = torch.as_tensor(test["attention_mask"][:RD_BATCH]).to("cuda")
    decode_ms = {}
    for name, beams in (("greedy", 1), (f"beam{RD_BEAMS}", RD_BEAMS)):
        seq2seq_generate(model, ids64, mask64, num_beams=beams,
                         **dict(common, max_new_tokens=4))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq2seq_generate(model, ids64, mask64, num_beams=beams, **common)
        torch.cuda.synchronize()
        decode_ms[name] = (time.perf_counter() - t0) * 1e3 / RD_DEC
    decode_profile = profile_decode(
        lambda: seq2seq_generate(model, ids64, mask64,
                                 **dict(common, max_new_tokens=RD_PROF_NEW)),
        RD_PROF_NEW)
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    del model, batch, ids64, mask64
    gc.collect()
    torch.cuda.empty_cache()

    # 4. 2 layers at full width through an HF-named checkpoint
    raw2 = dict(raw, num_layers=RD_CKPT_LAYERS,
                num_decoder_layers=RD_CKPT_LAYERS)
    cfg2 = T5Config(**{k: v for k, v in raw2.items()
                       if not k.startswith("_") and k != "model_type"})
    src = T5ForConditionalGeneration(cfg2, device="cuda",
                                     generator=torch.Generator(
                                         device="cuda").manual_seed(4))
    hf_dir = config_dir(workdir / "randeng_hf2", raw2)
    t0 = time.perf_counter()
    exported = write_safetensors(
        hf_dir / "model.safetensors",
        convert.params_to_torch_state(src.state_dict(), cfg2))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, dst = convert.load_hf_pretrained(str(hf_dir), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        ckpt_bitwise = all(torch.equal(
            src(ids, greedy[:, :-1], attention_mask=mask),
            dst(ids, greedy[:, :-1], attention_mask=mask))
            for _ in range(2))
    if not ckpt_bitwise:
        failures.append("2-layer HF checkpoint: logits not bitwise")
    del src, dst
    shutil.rmtree(hf_dir)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    if any(launches.values()):
        failures.append(f"kernel launches on the summary path: {launches}")
    tokens = RD_BATCH * (RD_ENC + RD_DEC)
    tokens_per_s = tokens / median_s
    say("randeng", card=card, config=RANDENG_CONFIG.name,
        n_params=n_params, layers=[cfg.num_layers, cfg.num_decoder_layers],
        steps=RD_STEPS, batch=RD_BATCH, enc_len=RD_ENC, dec_len=RD_DEC,
        disk_free_gib=free, fit_s=fit_s, step1_s=steps[0]["step_time_s"],
        step_time_s_median=median_s,
        step_time_s_range=[step_s[0], step_s[-1]],
        step_s=[e["step_time_s"] for e in steps],
        tokens_per_step=tokens, tokens_counted="encoder and decoder",
        tokens_per_s=tokens_per_s, flops_per_token=flops_per_token,
        mfu=flops_per_token * tokens_per_s / BF16_FLOPS,
        max_memory_allocated_gib=peak_gib, losses=losses, val_loss=vals,
        kept_steps=kept, best_step=best, rouge=rouge,
        predict_rows=pred_rows, beam_rows=beam_rows,
        eval_only_greedy_equal=eval_equal, beam_eval_s=beam_eval_s,
        greedy_eval_s=greedy_eval_s, profile=profile,
        bf16_vs_fp32_rel_l2=rel, encoder_mask_dropped_rel_l2=rel_fault,
        bf16_rtol=RD_BF16_RTOL, bf16_rows_pad_share=pad_share,
        tf_rows=RD_TF_ROWS, tf_tokens=total, tf_exact_argmax=exact,
        tf_worst_gap=worst_gap, tf_worst_gap_ulps=worst_ulps,
        tf_margin=TF_MARGIN, tie_ulps=RD_TIE_ULPS,
        greedy_mean_logprob=scores["greedy"],
        beam_mean_logprob=scores["beam"],
        beam_minus_greedy=beam_minus_greedy, beam_margin=RD_BEAM_MARGIN,
        decode_ms_per_step_batch64=decode_ms,
        greedy_decode_profile=decode_profile,
        export_gib=exported / 2**30,
        export_write_gib_per_s=exported / 2**30 / max(export_s, 1e-9),
        hf_load_s=load_s, hf_ckpt_bitwise=ckpt_bitwise,
        ckpt_saves=io["saves"], ckpt_gib_written=io["bytes_written"] / 2**30,
        ckpt_write_gib_per_s=io["bytes_written"] / 2**30 /
        max(io["save_s"], 1e-9),
        ckpt_restores=io["restores"], ckpt_gib_read=io["bytes_read"] / 2**30,
        ckpt_read_gib_per_s=io["bytes_read"] / 2**30 /
        max(io["restore_s"], 1e-9),
        kernel_launches=launches, phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("randeng: " + "; ".join(failures))


# -- phases 15-16 ----------------------------------------------------------

#: phase 15: pretrain_randeng_t5_char_700M.sh's flags, cut to PT_STEPS
#: steps (its warmup of 10000 to PT_WARMUP, its checkpoint interval of
#: 5000 to PT_STEPS: one checkpoint); its mesh flags at 1, one card
PT_STEPS, PT_BATCH, PT_SEQ, PT_WARMUP, PT_VAL = 20, 8, 512, 2, 16
#: text records: a quarter of LCSTS's text length (80-128 characters),
#: the rest long enough to fill the 512 encoder tokens (568 raw tokens
#: before corruption), so batches are full and some rows padded
PT_SHORT, PT_LONG = (80, 129), (600, 1200)
#: the span-corruption sentinels the char-level T5Tokenizer appends
N_SENTINELS = 118
#: free device memory and disk under TMPDIR each phase needs: phase 15
#: keeps one 9.4 GB checkpoint of 784M parameters (fp32 weights and both
#: AdamW moments) at a time
PT_MIN_FREE_GIB, PT_MIN_DISK_GIB = 60, 12
#: the CMRC shell's batch (the largest batch the card's memory takes
#: when 32 does not fit), steps cut from 100000 (and its checkpoint
#: interval to them), lengths; test rows decoded with its beam 4
QA_BATCH, QA_STEPS, QA_SEQ, QA_TARGET, QA_TEST = 32, 10, 512, 64, 16
#: the share of the card's memory a reckoned batch is planned to fill,
#: and the batches of the memory probe's two measured steps
MEM_SHARE, PROBE_ROWS = 0.85, (4, 8)
#: phase 16: the JAX package's default geometries, full depth; the
#: shells' batches, lengths and learning rates, steps cut from 100000,
#: warmup from 1000 to PT_WARMUP; their checkpoint interval of 5000
#: steps, so the fits write none
BART_PARAMS, PEG_PARAMS, DLM_PARAMS = 139_470_681, 568_796_007, 362_510_592
BART_STEPS, BART_BATCH, BART_SEQ = 20, 16, 512
QG_STEPS, QG_BATCH, QG_SEQ, QG_TARGET = 10, 32, 512, 64
PEG_STEPS, PEG_BATCH, PEG_SEQ, PEG_TARGET = 10, 32, 512, 128
DLM_STEPS, DLM_BATCH, DLM_LEN = 10, 16, 256
#: rows and new tokens of DeltaLM's cached greedy decode
DLM_TF_ROWS, DLM_NEW = 8, 64
FAM_MIN_FREE_GIB, FAM_MIN_DISK_GIB = 50, 4


class PretrainTokenizer:
    """A character tokenizer with the surface the pretraining examples
    read (the card's machine has no Randeng vocabulary, no
    ``transformers`` and no ``jieba``): the specials ``[PAD] [EOS] [UNK]
    [CLS] [SEP] [MASK] <ans>`` at ids 0-6 (pad and eos where the
    family's config puts them), then the phase's characters, and
    N_SENTINELS ascending ``<extra_id_i>`` at the top of the
    ``vocab_size`` ids, as the char-level T5Tokenizer appends them.
    Specials and sentinels encode as one token each."""

    SPECIALS = ("[PAD]", "[EOS]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                "<ans>")
    _SPLIT = re.compile(r"(\[[A-Z]+\]|<ans>|<extra_id_\d+>)")
    sep_token, mask_token = "[SEP]", "[MASK]"

    def __init__(self, chars: str, vocab_size: int, pad: int = 0,
                 eos: int = 1):
        order = [None] * len(self.SPECIALS)
        order[pad], order[eos] = "[PAD]", "[EOS]"
        rest = iter(s for s in self.SPECIALS if s not in ("[PAD]", "[EOS]"))
        order = [s if s is not None else next(rest) for s in order]
        self.vocab = {t: i for i, t in enumerate(order)}
        self.vocab.update({c: i + len(order) for i, c in enumerate(chars)})
        first = vocab_size - N_SENTINELS
        self.sentinel_token_ids = list(range(first, vocab_size))
        self.vocab.update({f"<extra_id_{i}>": first + i
                           for i in range(N_SENTINELS)})
        self.tokens = {i: t for t, i in self.vocab.items()}
        self.vocab_size = vocab_size
        (self.pad_token_id, self.eos_token_id, self.unk_token_id,
         self.cls_token_id, self.sep_token_id, self.mask_token_id) = (
            self.vocab[t] for t in self.SPECIALS[:6])

    def __len__(self) -> int:
        return self.vocab_size

    def get_vocab(self) -> dict:
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        ids = []
        for part in self._SPLIT.split(text):
            if part in self.vocab:
                ids.append(self.vocab[part])
            else:
                ids.extend(self.vocab.get(c, self.unk_token_id)
                           for c in part)
        return ids

    def batch_decode(self, rows, skip_special_tokens=False):
        return ["".join(self.tokens.get(int(i), "") for i in row
                        if not (skip_special_tokens and
                                int(i) < len(self.SPECIALS)))
                for row in rows]


def two_char_words(text: str) -> list:
    """The word segmenter handed to ``BartDataset`` (the card's machine
    has no ``jieba``): two characters a word, most Chinese words'
    length."""
    return [text[i:i + 2] for i in range(0, len(text), 2)]


def check_room(phase: str, workdir: Path, min_free_gib: float,
               min_disk_gib: float) -> tuple:
    """``(free device GiB, free disk GiB under workdir)``; raises when
    either is short of what the phase needs."""
    import shutil

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2**30
    disk = shutil.disk_usage(workdir).free / 2**30
    if free < min_free_gib or disk < min_disk_gib:
        raise AssertionError(
            f"{phase}: {free:.1f} GiB of device memory and {disk:.1f} GiB "
            f"of disk free under {workdir}; the phase needs "
            f"{min_free_gib} and {min_disk_gib}")
    return free, disk


def sentinels_in_order(batch: dict, sentinels) -> bool:
    """Each row's labels hold its input's sentinels, the first ones in
    ascending order (the span-corruption contract)."""
    ids = set(int(s) for s in sentinels)
    for inp, lab in zip(batch["input_ids"], batch["labels"]):
        a = [int(t) for t in inp if int(t) in ids]
        b = [int(t) for t in lab if int(t) in ids]
        if a != b or a != [int(s) for s in sentinels[:len(a)]]:
            return False
    return True


def shifted_sentinels(batch: dict, sentinels) -> dict:
    """The planted fault: every sentinel of the labels replaced by the
    next one."""
    import numpy as np
    nxt = {int(a): int(b) for a, b in zip(sentinels[:-1], sentinels[1:])}
    labels = np.array(batch["labels"])
    for (r, c), t in np.ndenumerate(labels):
        if int(t) in nxt:
            labels[r, c] = nxt[int(t)]
    return dict(batch, labels=labels)


def count_params(model_cls, cfg) -> int:
    import torch
    with torch.device("meta"):
        return sum(p.numel() for p in model_cls(cfg, device="meta")
                   .parameters())


def reckon_batch(module, collate, want: int) -> dict:
    """The largest batch up to ``want`` that the card's memory takes,
    planned to fill MEM_SHARE of it. A training step's peak is the
    larger of its backward's (weights, gradients, AdamW's moments and
    the activations, which grow with the rows) and its optimizer
    step's (weights, gradients, moments and AdamW's temporaries). One
    step (forward with dropout, backward, AdamW) at one row of
    ``collate(rows)`` makes the moments; steps at each of PROBE_ROWS
    rows then give the backward peak's slope per row and intercept, and
    the optimizer step's peak. The probe model is the caller's, at the
    fit's geometry."""
    import torch
    from fengshen_tpu_torch.ops.dropout import step_generator

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    model = module.model
    optimizer, _ = module.configure_optimizers(10, model)
    backward, opt_peak = {}, 0
    for rows in (1,) + PROBE_ROWS:
        gc.collect()
        torch.cuda.empty_cache()
        batch = {k: torch.as_tensor(v).to("cuda")
                 for k, v in collate(rows).items()}

        def forward_backward():
            module.set_dropout_generator(step_generator(0, rows))
            loss, _ = module.training_loss(batch)
            loss.backward()
            module.set_dropout_generator(None)

        backward[rows] = peak_of(forward_backward)
        opt_peak = max(opt_peak, peak_of(optimizer.step))
        optimizer.zero_grad(set_to_none=True)
        del batch
    del optimizer
    lo, hi = PROBE_ROWS
    slope = max((backward[hi] - backward[lo]) / (hi - lo), 1.0)
    intercept = backward[lo] - lo * slope
    total = torch.cuda.get_device_properties(0).total_memory
    fits = int((MEM_SHARE * total - intercept) // slope)
    if opt_peak > MEM_SHARE * total:
        fits = 0
    rows = max(1, min(want, fits))
    return {"batch": rows, "want": want, "cut": rows < want,
            "per_row_gib": slope / 2**30, "intercept_gib": intercept / 2**30,
            "backward_peaks_gib": {r: v / 2**30 for r, v in
                                   backward.items()},
            "optimizer_peak_gib": opt_peak / 2**30,
            "planned_peak_gib": max(intercept + rows * slope,
                                    opt_peak) / 2**30,
            "card_gib": total / 2**30}


def fit_report(trainer, tokens_per_step: int, skip=()) -> dict:
    """Step time (median and range of steps 2 on, but ``skip``),
    tokens/s, MFU by the module's ``flops_per_token``, peak memory since
    the last reset, losses."""
    import numpy as np
    import torch
    steps = [e for e in trainer.history if "loss" in e and
             "step_time_s" in e]
    times = sorted(e["step_time_s"] for e in steps
                   if e["step"] >= 2 and e["step"] not in skip)
    median = times[len(times) // 2]
    fpt = steps[-1]["flops_per_token"]
    losses = [e["loss"] for e in steps]
    return {"steps": len(steps), "step1_s": steps[0]["step_time_s"],
            "step_time_s_median": median,
            "step_time_s_range": [times[0], times[-1]],
            "tokens_per_step": tokens_per_step,
            "tokens_per_s": tokens_per_step / median,
            "flops_per_token": fpt,
            "mfu": fpt * tokens_per_step / median / BF16_FLOPS,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "losses": losses,
            "losses_finite": bool(np.isfinite(losses).all())}


def run_fit(main_fn, argv, **kw):
    """``main_fn(argv, **kw)`` from a clean allocator, peak memory reset;
    returns ``(trainer, seconds)``."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = main_fn(argv, **kw)
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


def fit_argv(workdir: Path, name: str, steps: int, batch: int, lr: float,
             extra=()) -> list:
    """The shells' shared flags with this phase's cuts: ``steps`` steps,
    warmup PT_WARMUP, one log line a step, seed 1234, bf16 on the card."""
    return [str(x) for x in (
        "--default_root_dir", workdir / name / "runs", "--save_ckpt_path",
        workdir / name / "ckpt", "--load_ckpt_path", workdir / name / "ckpt",
        "--train_batchsize", batch, "--max_steps", steps,
        "--learning_rate", lr, "--warmup_steps", PT_WARMUP,
        "--precision", "bf16", "--log_every_n_steps", 1, "--seed", 1234,
        "--device", "cuda", *extra)]


def bf16_bar(model, batch: dict) -> tuple:
    """``(rel L2 of the bf16 logits from fp32 compute, the same with the
    encoder padding mask dropped)`` on ``batch``."""
    import torch

    def logits(dtype, mask=True):
        before, model.config.dtype = model.config.dtype, dtype
        try:
            with torch.no_grad():
                return model(batch["input_ids"], batch["decoder_input_ids"],
                             attention_mask=batch["attention_mask"]
                             if mask else None).float()
        finally:
            model.config.dtype = before

    want = logits("float32")
    rel = ((logits("bfloat16") - want).norm() / want.norm()).item()
    fault = ((logits("bfloat16", mask=False) - want).norm() /
             want.norm()).item()
    return rel, fault


def phase_randeng_pretrain(workdir: Path, card):
    """``pretrain_t5.main`` with the flags of
    ``pretrain_randeng_t5_char_700M.sh`` on Randeng-T5-784M
    (``configs/randeng_t5_784m.json``: all 24 + 24 layers, 784,108,544
    parameters checked first; fp32 weights made on the card from a seed,
    bf16 compute, dropout 0.1) over text records made from a seed:
    PT_STEPS steps of 8 x (512 + 114) span-corruption tokens, one
    checkpoint; every batch's labels must hold its input's sentinels in
    order (labels with their sentinels shifted by one must fail that).
    ``--do_eval_only`` restores the step and runs one validation sweep,
    no step. On those weights the bf16 forward is held to fp32 compute
    on the validation rows with the most padding (the encoder mask
    dropped must break the bar). Then ``finetune_t5_cmrc.main`` with the
    CMRC shell's flags at the same geometry (its batch of 32, or the
    largest that fits, reckoned first): QA_STEPS steps and one
    checkpoint, then ``--do_eval_only`` writes its beam-4 predictions.
    K1-K4 launch 0 times."""
    import shutil

    import numpy as np
    import torch
    from fengshen_tpu_torch.data.t5_dataloader import (
        T5SpanCorruptionCollator, compute_input_and_target_lengths)
    from fengshen_tpu_torch.examples.pretrain_t5 import pretrain_t5
    from fengshen_tpu_torch.examples.qa_t5 import finetune_t5_cmrc as qa
    from fengshen_tpu_torch.models.t5 import (T5Config,
                                              T5ForConditionalGeneration)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts

    free, disk = check_room("randeng_pretrain", workdir, PT_MIN_FREE_GIB,
                            PT_MIN_DISK_GIB)
    t_phase = time.perf_counter()
    failures = []
    reset_launch_counts()
    raw = json.loads(RANDENG_CONFIG.read_text())
    cfg = T5Config.from_pretrained(str(RANDENG_CONFIG))
    n_params = count_params(T5ForConditionalGeneration, cfg)
    if n_params != RD_PARAMS or (cfg.num_layers, cfg.num_decoder_layers) \
            != (24, 24):
        raise AssertionError(f"randeng_pretrain: {n_params} parameters, "
                             f"{cfg.num_layers} + {cfg.num_decoder_layers} "
                             f"layers (want {RD_PARAMS}, 24 + 24)")
    _, targets = compute_input_and_target_lengths(PT_SEQ, 0.15, 3.0)
    model_dir = config_dir(workdir / "randeng_t5", raw)
    rng = np.random.RandomState(15)
    chars = "".join(chr(0x4E00 + i) for i in range(RD_CHARS))
    tok = PretrainTokenizer(chars, cfg.vocab_size, cfg.pad_token_id,
                            cfg.eos_token_id)
    pool = list(chars)

    def texts(n):
        return ["".join(rng.choice(pool, rng.randint(
            *(PT_SHORT if rng.rand() < 0.25 else PT_LONG))))
            for _ in range(n)]

    train = write_jsonl(workdir / "pt_train.json",
                        [{"text": t} for t in texts(PT_STEPS * PT_BATCH)])
    val_rows = [{"text": t} for t in texts(PT_VAL)]
    val = write_jsonl(workdir / "pt_val.json", val_rows)
    cuts = {"max_steps": [100000, PT_STEPS], "warmup_steps":
            [10000, PT_WARMUP], "every_n_train_steps": [5000, PT_STEPS],
            "fsdp_parallel_size": [8, 1]}
    argv = [str(x) for x in (
        "--tokenizer_type", "bert_tokenizer", "--model_path", model_dir,
        "--train_file", train, "--val_file", val, "--val_batchsize",
        PT_BATCH, "--max_seq_length", PT_SEQ, "--min_learning_rate", 1e-5,
        "--every_n_train_steps", PT_STEPS, "--tensor_model_parallel_size",
        1, "--fsdp_parallel_size", 1, "--profile_steps",
        ",".join(map(str, RD_PROFILE)))]
    argv += fit_argv(workdir, "pt", PT_STEPS, PT_BATCH, 1e-4)

    # 1. the shell's pretraining, each batch's sentinels checked
    seen = {"batches": 0, "out_of_order": 0}
    real_call = T5SpanCorruptionCollator.__call__

    def checked(self, samples):
        batch = real_call(self, samples)
        seen["batches"] += 1
        seen["out_of_order"] += not sentinels_in_order(batch,
                                                       self.sentinels)
        return batch

    with patched(T5SpanCorruptionCollator, "__call__", checked):
        trainer, fit_s = run_fit(pretrain_t5.main, argv, tokenizer=tok)
    profiled = set(range(RD_PROFILE[0] + 1, RD_PROFILE[1] + 1))
    report = fit_report(trainer, PT_BATCH * (PT_SEQ + targets),
                        profiled | {RD_PROFILE[1] + 1})
    profile = step_profile(trainer, profiled)
    losses = report["losses"]
    accs = [e["acc"] for e in trainer.history if "acc" in e and
            "step_time_s" in e]
    io = dict(next(c for c in trainer.callbacks if hasattr(c, "stats"))
              .stats)
    fit_vals = [e for e in trainer.history if "val_loss" in e]
    if len(losses) != PT_STEPS or not report["losses_finite"] or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        failures.append(f"pretraining losses {losses}")
    if seen["out_of_order"] or seen["batches"] < PT_STEPS:
        failures.append(f"sentinel check: {seen}")
    if io["saves"] != 1:
        failures.append(f"{io['saves']} checkpoints (want 1)")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 2. --do_eval_only: the restored step, one validation sweep, no step
    eval_argv = argv[:argv.index("--profile_steps")] + \
        argv[argv.index("--profile_steps") + 2:] + ["--do_eval_only"]
    with patched(T5SpanCorruptionCollator, "__call__", checked):
        ev, eval_s = run_fit(pretrain_t5.main, eval_argv, tokenizer=tok)
    ev_vals = [e for e in ev.history if "val_loss" in e]
    ev_steps = [e for e in ev.history if "loss" in e]
    if ev.global_step != PT_STEPS or len(ev_vals) != 1 or ev_steps or \
            not np.isfinite(ev_vals[0]["val_loss"]):
        failures.append(f"--do_eval_only: step {ev.global_step}, "
                        f"validations {ev_vals}, steps {len(ev_steps)}")
    eval_io = next(c for c in ev.callbacks if hasattr(c, "stats")).stats
    model = ev.state.model
    model.requires_grad_(False)

    # 3. bf16 against fp32 on the most padded validation rows; the
    # sentinel check against shifted sentinels
    collated = T5SpanCorruptionCollator(tok, max_seq_length=PT_SEQ,
                                        seed=15)(val_rows)
    rows = np.argsort(collated["attention_mask"].sum(1),
                      kind="stable")[:PT_BATCH]
    batch = {k: torch.as_tensor(v[rows]).to("cuda")
             for k, v in collated.items()}
    pad_share = 1.0 - batch["attention_mask"].float().mean().item()
    rel, rel_fault = bf16_bar(model, batch)
    if rel > RD_BF16_RTOL or rel_fault <= RD_BF16_RTOL or pad_share == 0:
        failures.append(f"bf16 vs fp32 logits rel L2 {rel} (limit "
                        f"{RD_BF16_RTOL}); encoder mask dropped "
                        f"{rel_fault}; pad share {pad_share}")
    shifted_caught = sentinels_in_order(collated, tok.sentinel_token_ids) \
        and not sentinels_in_order(
            shifted_sentinels(collated, tok.sentinel_token_ids),
            tok.sentinel_token_ids)
    if not shifted_caught:
        failures.append("the sentinel check passed shifted sentinels")
    del model, ev, batch
    shutil.rmtree(workdir / "pt" / "ckpt")
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the CMRC QA fine-tune at the same geometry, its batch reckoned
    def qa_records(n):
        out = []
        for _ in range(n):
            context = "".join(rng.choice(pool, rng.randint(400, 600)))
            s = rng.randint(0, len(context) - 10)
            out.append({"question": "".join(rng.choice(pool,
                                                       rng.randint(8, 20))),
                        "context": context,
                        "answer": context[s:s + rng.randint(2, 10)]})
        return out

    qa_cuts = ["--max_seq_length", str(QA_SEQ), "--max_target_length",
               str(QA_TARGET)]
    qa_args = qa.parse_args(qa_cuts + ["--model_path", str(model_dir)])
    probe_records = qa_records(max(PROBE_ROWS))
    probe_model = T5ForConditionalGeneration(
        cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(15))
    plan = reckon_batch(
        qa.T5QAModule(qa_args, probe_model, cfg),
        lambda n: qa.T5QACollator(
            tok, max_src_length=QA_SEQ, max_tgt_length=QA_TARGET,
            decoder_start_token_id=cfg.decoder_start_token_id)(
                probe_records[:n]), QA_BATCH)
    del probe_model
    qa_batch = plan["batch"]
    qa_train = write_jsonl(workdir / "qa_train.json",
                           qa_records(QA_STEPS * qa_batch))
    qa_test = write_jsonl(workdir / "qa_test.json", qa_records(QA_TEST))
    qa_argv = qa_cuts + [str(x) for x in (
        "--model_path", model_dir, "--train_file", qa_train, "--test_file",
        qa_test, "--test_batchsize", QA_TEST, "--every_n_train_steps",
        QA_STEPS)] + fit_argv(workdir, "qa", QA_STEPS, qa_batch, 1e-4)
    qa_trainer, qa_fit_s = run_fit(qa.main, qa_argv, tokenizer=tok)
    qa_report = fit_report(qa_trainer, qa_batch * (QA_SEQ + QA_TARGET))
    del qa_trainer
    pred_path = workdir / "qa_predictions.txt"
    qa_eval, qa_pred_s = run_fit(qa.main, qa_argv + [
        "--do_eval_only", "--prediction_res_path", str(pred_path)],
        tokenizer=tok)
    pred_lines = pred_path.read_text().splitlines()
    if len(qa_report["losses"]) != QA_STEPS or \
            not qa_report["losses_finite"] or \
            qa_eval.global_step != QA_STEPS or len(pred_lines) != QA_TEST:
        failures.append(f"qa: losses {qa_report['losses']}, restored step "
                        f"{qa_eval.global_step}, {len(pred_lines)} "
                        f"predictions (want {QA_TEST})")
    del qa_eval
    shutil.rmtree(workdir / "qa" / "ckpt")
    gc.collect()
    torch.cuda.empty_cache()
    launches = kernel_launches()
    if any(launches.values()):
        failures.append(f"kernel launches on the pretraining path: "
                        f"{launches}")
    say("randeng_pretrain", card=card, config=RANDENG_CONFIG.name,
        n_params=n_params, layers=[cfg.num_layers, cfg.num_decoder_layers],
        cuts=cuts, batch=PT_BATCH, enc_len=PT_SEQ, dec_len=targets,
        device_free_gib=free, disk_free_gib=disk, fit_s=fit_s, **report,
        acc=accs, fit_validation=fit_vals, profile=profile,
        sentinel_check=seen, shifted_sentinels_caught=shifted_caught,
        eval_only_s=eval_s, eval_only_validation=ev_vals,
        bf16_vs_fp32_rel_l2=rel, encoder_mask_dropped_rel_l2=rel_fault,
        bf16_rtol=RD_BF16_RTOL, bf16_rows_pad_share=pad_share,
        ckpt_saves=io["saves"], ckpt_gib_written=io["bytes_written"] / 2**30,
        ckpt_write_gib_per_s=io["bytes_written"] / 2**30 /
        max(io["save_s"], 1e-9),
        ckpt_gib_read=eval_io["bytes_read"] / 2**30,
        ckpt_read_gib_per_s=eval_io["bytes_read"] / 2**30 /
        max(eval_io["restore_s"], 1e-9),
        kernel_launches=launches, phase_s=time.perf_counter() - t_phase)
    say("randeng_qa", card=card, shell_batch=QA_BATCH, memory_plan=plan,
        batch=qa_batch, enc_len=QA_SEQ, dec_len=QA_TARGET, fit_s=qa_fit_s,
        **qa_report, predict_s=qa_pred_s, predictions=len(pred_lines),
        first_prediction=pred_lines[0] if pred_lines else None)
    if failures:
        raise AssertionError("randeng_pretrain: " + "; ".join(failures))


def phase_seq2seq_families(workdir: Path, card):
    """The other families at the JAX package's default geometries and
    full depth, through their examples' ``main`` with the shells' flags
    on records made from a seed, fp32 weights made on the card from a
    seed, bf16 compute: ``pretrain_bart.main`` at ``BartConfig()`` (6 +
    6 layers of 768, 139,470,681 parameters) over an
    ``MMapIndexedDataset`` the phase writes with the port's builder,
    BART_STEPS steps of 16 x 512; ``finetune_bart.main`` on the weights
    that fit leaves (exported HF-named), ``--mask_ans_style anstoken``,
    QG_STEPS steps; ``pretrain_pegasus.main`` at ``PegasusConfig()`` (16
    + 16 of 1024, 568,796,007), ``--gsg_ratio 0.25``, its batch of 32 or
    the largest that fits; ``finetune_deltalm.main`` at
    ``DeltaLMConfig()`` (12 + 6 of 768, 362,510,592), 16 x (256 + 256),
    ``--label_smooth 0.1``, then DLM_TF_ROWS rows of cached greedy
    decode each token within TF_MARGIN, or RD_TIE_ULPS bf16 ulps, of one
    uncached forward's argmax. K1-K4 launch 0 times."""
    import numpy as np
    import torch
    from fengshen_tpu_torch.data.megatron_dataloader import \
        MMapIndexedDatasetBuilder
    from fengshen_tpu_torch.examples.finetune_bart_qg import finetune_bart
    from fengshen_tpu_torch.examples.pegasus import pretrain_pegasus
    from fengshen_tpu_torch.examples.summary.seq2seq_summary import \
        common_parser
    from fengshen_tpu_torch.examples.pretrain_randeng_bart import \
        pretrain_bart
    from fengshen_tpu_torch.examples.translate import finetune_deltalm
    from fengshen_tpu_torch.models.bart import (BartConfig,
                                                BartForConditionalGeneration)
    from fengshen_tpu_torch.models.bart import convert as bart_convert
    from fengshen_tpu_torch.models.deltalm import (
        DeltaLMConfig, DeltaLMForConditionalGeneration)
    from fengshen_tpu_torch.models.pegasus import (
        PegasusConfig, PegasusForConditionalGeneration)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.utils.generate import seq2seq_generate

    free, disk = check_room("seq2seq_families", workdir, FAM_MIN_FREE_GIB,
                            FAM_MIN_DISK_GIB)
    t_phase = time.perf_counter()
    failures, out = [], {}
    reset_launch_counts()
    rng = np.random.RandomState(16)
    chars = "".join(chr(0x4E00 + i) for i in range(RD_CHARS))
    pool = list(chars)

    def sentence(lo=15, hi=40):
        return "".join(rng.choice(pool, rng.randint(lo, hi))) + \
            rng.choice(list("。！？；"))

    geometry = {}
    for name, cls, cfg, want in (
            ("bart", BartForConditionalGeneration, BartConfig(),
             BART_PARAMS),
            ("pegasus", PegasusForConditionalGeneration, PegasusConfig(),
             PEG_PARAMS),
            ("deltalm", DeltaLMForConditionalGeneration, DeltaLMConfig(),
             DLM_PARAMS)):
        n = count_params(cls, cfg)
        geometry[name] = {"n_params": n, "layers": [cfg.encoder_layers,
                                                    cfg.decoder_layers],
                          "d_model": cfg.d_model}
        if n != want:
            raise AssertionError(f"seq2seq_families: {name} has {n} "
                                 f"parameters (want {want})")

    # BART text infilling over an indexed corpus, then QG on its weights
    bcfg = BartConfig()
    btok = PretrainTokenizer(chars, bcfg.vocab_size, bcfg.pad_token_id,
                             bcfg.eos_token_id)
    bart_dir = workdir / "bart"
    bcfg.save_pretrained(str(bart_dir))
    builder = MMapIndexedDatasetBuilder(str(workdir / "bart_corpus"))
    for _ in range(BART_STEPS * BART_BATCH):
        for _ in range(rng.randint(12, 24)):
            builder.add_item(btok.encode(sentence()) + [btok.sep_token_id])
        builder.end_document()
    builder.finalize()
    argv = ["--model_path", str(bart_dir), "--data_prefix",
            str(workdir / "bart_corpus"), "--max_seq_length", str(BART_SEQ),
            "--every_n_train_steps", "5000"] + \
        fit_argv(workdir, "bart", BART_STEPS, BART_BATCH, 2e-5)
    trainer, fit_s = run_fit(pretrain_bart.main, argv, tokenizer=btok,
                             zh_tokenizer=two_char_words)
    out["bart"] = dict(fit_report(trainer, BART_BATCH * 2 * BART_SEQ),
                       fit_s=fit_s, batch=BART_BATCH, lengths=[BART_SEQ,
                                                               BART_SEQ])
    qg_dir = workdir / "bart_qg"
    bcfg.save_pretrained(str(qg_dir))
    write_safetensors(qg_dir / "model.safetensors",
                      bart_convert.params_to_torch_state(
                          trainer.state.model.state_dict(), bcfg))
    del trainer
    qg_rows = []
    for _ in range(QG_STEPS * QG_BATCH):
        context = "".join(sentence() for _ in range(rng.randint(8, 14)))
        s = rng.randint(0, len(context) - 10)
        k = rng.randint(2, 9)
        qg_rows.append({"context": context, "answer": context[s:s + k],
                        "ans_span": [[s, s + k]],
                        "question": sentence(8, 24)})
    argv = ["--model_path", str(qg_dir), "--train_file",
            str(write_jsonl(workdir / "qg.json", qg_rows)),
            "--mask_ans_style", "anstoken", "--every_n_train_steps",
            "5000"] + fit_argv(workdir, "qg", QG_STEPS, QG_BATCH, 1e-4)
    trainer, fit_s = run_fit(finetune_bart.main, argv, tokenizer=btok)
    out["bart_qg"] = dict(fit_report(trainer, QG_BATCH * (QG_SEQ +
                                                          QG_TARGET)),
                          fit_s=fit_s, batch=QG_BATCH,
                          lengths=[QG_SEQ, QG_TARGET])
    del trainer

    # Pegasus gap sentences, the batch reckoned
    pcfg = PegasusConfig()
    ptok = PretrainTokenizer(chars, pcfg.vocab_size, pcfg.pad_token_id,
                             pcfg.eos_token_id)
    peg_dir = workdir / "pegasus"
    pcfg.save_pretrained(str(peg_dir))

    def documents(n):
        return [{"text": "".join(sentence() for _ in range(
            rng.randint(14, 30)))} for _ in range(n)]

    peg_args = pretrain_pegasus.PegasusPretrainModule.\
        add_module_specific_args(common_parser()).parse_args(
            ["--max_seq_length", str(PEG_SEQ)])
    probe_docs = documents(max(PROBE_ROWS))
    probe_model = PegasusForConditionalGeneration(
        pcfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(16))
    plan = reckon_batch(
        pretrain_pegasus.PegasusPretrainModule(peg_args, probe_model, pcfg),
        lambda n: pretrain_pegasus.PegasusGSGCollator(
            ptok, max_src_length=PEG_SEQ, max_tgt_length=PEG_TARGET,
            decoder_start_token_id=ptok.pad_token_id)(probe_docs[:n]),
        PEG_BATCH)
    del probe_model
    peg_batch = plan["batch"]
    argv = ["--model_path", str(peg_dir), "--train_file",
            str(write_jsonl(workdir / "peg.json",
                            documents(PEG_STEPS * peg_batch))),
            "--max_seq_length", str(PEG_SEQ), "--gsg_ratio", "0.25",
            "--every_n_train_steps", "5000"] + \
        fit_argv(workdir, "pegasus", PEG_STEPS, peg_batch, 1e-4)
    trainer, fit_s = run_fit(pretrain_pegasus.main, argv, tokenizer=ptok)
    out["pegasus"] = dict(fit_report(trainer, peg_batch * (PEG_SEQ +
                                                           PEG_TARGET)),
                          fit_s=fit_s, batch=peg_batch, shell_batch=PEG_BATCH,
                          memory_plan=plan, lengths=[PEG_SEQ, PEG_TARGET])
    del trainer

    # DeltaLM translation, then cached greedy decode
    dcfg = DeltaLMConfig()
    dtok = PretrainTokenizer(chars, dcfg.vocab_size, dcfg.pad_token_id,
                             dcfg.eos_token_id)
    dlm_dir = workdir / "deltalm"
    dcfg.save_pretrained(str(dlm_dir))
    pairs = [{"src": "".join(sentence() for _ in range(rng.randint(3, 12))),
              "tgt": "".join(sentence() for _ in range(rng.randint(3, 12)))}
             for _ in range(DLM_STEPS * DLM_BATCH)]
    argv = ["--model_path", str(dlm_dir), "--train_file",
            str(write_jsonl(workdir / "dlm.json", pairs)),
            "--max_enc_length", str(DLM_LEN), "--max_dec_length",
            str(DLM_LEN), "--label_smooth", "0.1", "--every_n_train_steps",
            "5000"] + fit_argv(workdir, "deltalm", DLM_STEPS, DLM_BATCH, 1e-4)
    trainer, fit_s = run_fit(finetune_deltalm.main, argv, tokenizer=dtok)
    out["deltalm"] = dict(fit_report(trainer, DLM_BATCH * 2 * DLM_LEN),
                          fit_s=fit_s, batch=DLM_BATCH,
                          lengths=[DLM_LEN, DLM_LEN])
    model = trainer.state.model
    model.requires_grad_(False)
    del trainer
    batch = finetune_deltalm.TranslationCollator(
        dtok, max_src_length=DLM_LEN, max_tgt_length=DLM_LEN)(
        pairs[:DLM_TF_ROWS])
    ids = torch.as_tensor(batch["input_ids"]).to("cuda")
    mask = torch.as_tensor(batch["attention_mask"]).to("cuda")
    t0 = time.perf_counter()
    greedy = seq2seq_generate(
        model, ids, mask, max_new_tokens=DLM_NEW,
        decoder_start_token_id=dcfg.decoder_start_token_id,
        eos_token_id=dcfg.eos_token_id, pad_token_id=dcfg.pad_token_id,
        device="cuda")
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DLM_NEW
    with torch.no_grad():
        pred = model(ids, greedy[:, :-1], attention_mask=mask).float()
    worst_gap = worst_ulps = 0.0
    exact = total = 0
    for b in range(DLM_TF_ROWS):
        row = greedy[b, 1:].tolist()
        t = row.index(dcfg.eos_token_id) + 1 if dcfg.eos_token_id in row \
            else DLM_NEW
        top = pred[b, :t].max(-1).values
        gap = top - pred[b, :t].gather(1, greedy[b, 1:t + 1, None])[:, 0]
        ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
        worst_gap = max(worst_gap, gap.max().item())
        worst_ulps = max(worst_ulps, (gap / ulp).max().item())
        bad = (gap > TF_MARGIN) & (gap > RD_TIE_ULPS * ulp)
        if bad.any():
            failures.append(f"deltalm cached greedy row {b}: a token "
                            f"{gap[bad].max().item()} below the uncached "
                            "argmax")
        exact += int((gap == 0).sum())
        total += t
    out["deltalm"].update(tf_rows=DLM_TF_ROWS, tf_tokens=total,
                          tf_exact_argmax=exact, tf_worst_gap=worst_gap,
                          tf_worst_gap_ulps=worst_ulps,
                          greedy_decode_ms_per_step=decode_ms)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name, (steps, rep) in {k: (s, out[k]) for k, s in (
            ("bart", BART_STEPS), ("bart_qg", QG_STEPS),
            ("pegasus", PEG_STEPS), ("deltalm", DLM_STEPS))}.items():
        if len(rep["losses"]) != steps or not rep["losses_finite"]:
            failures.append(f"{name} losses {rep['losses']}")
    launches = kernel_launches()
    if any(launches.values()):
        failures.append(f"kernel launches on the families' paths: "
                        f"{launches}")
    for name, rep in out.items():
        say(f"seq2seq_{name}", card=card,
            geometry=geometry[name.split("_")[0]], **rep)
    say("seq2seq_families", card=card, device_free_gib=free,
        disk_free_gib=disk, tf_margin=TF_MARGIN, tie_ulps=RD_TIE_ULPS,
        kernel_launches=launches, phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("seq2seq_families: " + "; ".join(failures))


# -- phase 17 -----------------------------------------------------------

#: MLM pretraining phase (17): the three encoders at their published
#: geometries and full depth, fp32 weights made on the card from a seed,
#: bf16 compute (the configs' default), dropout 0.1; their parameter
#: counts are checked before anything else
DEBERTA_CONFIG = ROOT / "configs" / "erlangshen_deberta_v2_710m.json"
BERT_BASE_CONFIG = ROOT / "configs" / "bert_base_chinese.json"
MB_PARAMS, DEB_PARAMS, BB_PARAMS = 1_261_593_346, 702_786_560, 102_290_312
#: 17a: an indexed corpus of IDX_DOCS documents of 1-19 sentences of
#: 1-21 tokens (about 1.0e7 sentences and 1.1e8 tokens, 0.57 GB of
#: int32 tokens and index), at least IDX_MIN_TOKENS tokens; BERT windows of 512 - 3
#: tokens with short windows at 0.1, GPT samples of 512, and two
#: datasets blended 0.7 / 0.3
IDX_DOCS, IDX_MIN_TOKENS = 1_000_000, 100_000_000
IDX_SENTS, IDX_SENT_LEN = (1, 20), (1, 22)
IDX_SEQ, IDX_SHORT, IDX_WEIGHTS = 512, 0.1, (0.7, 0.3)
#: 17b-17d: steps, length, the shells' batch of 32 rows (cut by the
#: memory probe where the card does not take it), the checkpoint of 17d
#: after MLM_CKPT_AT of BB_STEPS steps
MLM_STEPS, MLM_SEQ, MLM_BATCH = 20, 512, 32
BB_STEPS, MLM_CKPT_AT = 6, 5
#: the steps 17b traces (its steps 5 and 6), as phases 12-15 do
MLM_PROFILE = (4, 6)
#: text records: sentences of 8-40 characters drawn from MLM_CHARS CJK
#: characters with Zipf(1.1) frequencies (so the fit has a unigram law
#: to learn), a quarter of the records 100-300 characters long (padded
#: rows), the rest 600-900 (full 512-token rows)
MLM_CHARS, MLM_SENT_LEN, MLM_ZIPF = 3000, (8, 41), 1.1
MLM_SHORT, MLM_LONG = (100, 301), (600, 901)
#: free device memory and disk under TMPDIR the phase needs: the corpus
#: (0.57 GB), a BERT-base checkpoint (1.2 GB of weights and moments)
MLM_MIN_FREE_GIB, MLM_MIN_DISK_GIB = 60, 3


class MLMTokenizer:
    """A character tokenizer over the whole vocabulary with the surface
    the MLM collators and datasets read (the card's machine has no
    Erlangshen vocabulary, no ``transformers`` and no ``jieba``):
    ``[PAD] [UNK] [CLS] [SEP] [MASK]`` at ids 0-4, the sentence ends
    ``。！？`` at 5-7, then one CJK character per id up to
    ``vocab_size``."""

    pad_token_id, unk_token_id, cls_token_id = 0, 1, 2
    sep_token_id, mask_token_id = 3, 4
    FIRST_CHAR = 8

    def __init__(self, vocab_size: int):
        self.tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                       "。", "！", "？"] + [
            chr(0x4E00 + i) for i in range(vocab_size - self.FIRST_CHAR)]
        self.vocab = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self) -> int:
        return len(self.tokens)

    def get_vocab(self) -> dict:
        return dict(self.vocab)

    def encode(self, text, add_special_tokens=True):
        del add_special_tokens
        return [self.vocab.get(c, self.unk_token_id) for c in text]


def mlm_records(n: int, rng) -> list:
    """``n`` records ``{"text": ...}`` of Zipf-distributed characters in
    sentences (MLM_* above)."""
    import numpy as np
    ranks = np.arange(1, MLM_CHARS + 1)
    p = ranks ** -MLM_ZIPF
    p /= p.sum()
    chars = np.array([chr(0x4E00 + i) for i in range(MLM_CHARS)])
    out = []
    for _ in range(n):
        want = rng.randint(*(MLM_SHORT if rng.rand() < 0.25 else MLM_LONG))
        text = []
        while sum(map(len, text)) < want:
            text.append("".join(chars[rng.choice(
                MLM_CHARS, rng.randint(*MLM_SENT_LEN), p=p)]) +
                rng.choice(["。", "！", "？"]))
        out.append({"text": "".join(text)})
    return out


def mlm_argv(workdir: Path, name: str, model_dir: Path, train: Path,
             steps: int, batch: int, extra=()) -> list:
    """The flags every MLM fit of the phase shares: the model and data,
    ``steps`` steps of ``batch`` x MLM_SEQ, one log line a step, seed
    1234, on the card."""
    return [str(x) for x in (
        "--model_path", model_dir, "--train_file", train,
        "--max_seq_length", MLM_SEQ, "--masked_lm_prob", 0.15,
        "--train_batchsize", batch, "--max_steps", steps,
        "--default_root_dir", workdir / name / "runs", "--save_ckpt_path",
        workdir / name / "ckpt", "--load_ckpt_path", workdir / name / "ckpt",
        "--log_every_n_steps", 1, "--seed", 1234, "--device", "cuda",
        *extra)]


def deberta_flops_per_token(cfg, seq: int) -> float:
    """Forward plus backward FLOPs a token of DeBERTa-v2 at ``seq``
    tokens: 6 x the matrix parameters a token passes (each layer's 4 h^2
    + 2 h i, the MLM transform's h^2, the tied decoder's h V), plus per
    layer 6 x 2 x h x (seq for Q K^T, seq for P V, and 2 x
    position_buckets for each of c2p and p2c: each position term counted
    as the Q K^T product is). The per-batch projections of the
    relative-position table (2 x 2 x 512 x h^2 a layer, about 2 % at 8 x
    512) and the embedding lookups are left out."""
    h, layers = cfg.hidden_size, cfg.num_hidden_layers
    matrix = layers * (4 * h * h + 2 * h * cfg.intermediate_size) + \
        h * h + h * cfg.vocab_size
    span = 2 * cfg.pos_ebd_size
    attention = layers * 2 * h * (2 * seq + len(cfg.pos_att_type) * span)
    return 6.0 * matrix + 3.0 * attention


def mlm_bf16_bar(model, batch: dict) -> dict:
    """The MLM logits of the bf16 forward against fp32 compute on
    ``batch`` at its real (unpadded) tokens: ``{"rel_l2": ...,
    "mask_dropped_rel_l2": ...}``, the second with the padding mask
    dropped from the bf16 forward (the planted fault)."""
    import torch
    real = batch["attention_mask"].bool()

    def logits(dtype, mask=True):
        before, model.config.dtype = model.config.dtype, dtype
        try:
            with torch.no_grad():
                out = model(batch["input_ids"],
                            attention_mask=batch["attention_mask"]
                            if mask else None,
                            token_type_ids=batch.get("token_type_ids"))
            return (out[0] if isinstance(out, tuple) else out).float()[real]
        finally:
            model.config.dtype = before

    want = logits("float32")
    return {"rel_l2": ((logits("bfloat16") - want).norm() /
                       want.norm()).item(),
            "mask_dropped_rel_l2": ((logits("bfloat16", mask=False) -
                                     want).norm() / want.norm()).item()}


def initial_weights_bar(model_cls, cfg, batch: dict) -> dict:
    """:func:`mlm_bf16_bar` on a fit's step-0 weights, drawn as
    ``init_params`` draws them from ``--seed`` 1234. A freshly drawn
    encoder mixes its context (the padding mask moves its hidden states
    by about half their norm), so the dropped mask must break the bar
    here; after 20 steps on text with no context to learn the model
    predicts the unigram law everywhere and hardly reads its context, so
    on the trained weights the fault is only printed."""
    import torch
    from fengshen_tpu_torch.models.layers import init_weights
    model = model_cls(cfg, device="cuda", init=False)
    init_weights(model, torch.Generator(device="cuda").manual_seed(1234),
                 cfg.initializer_range)
    model.requires_grad_(False)
    bar = mlm_bf16_bar(model, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return bar


def to_card(batch: dict) -> dict:
    import torch
    return {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}


def phase_index_builders(workdir: Path, card) -> tuple:
    """17a, on the card's host: an indexed corpus of IDX_DOCS documents
    (about 1.1e8 tokens) written with the port's builder, then the index
    helpers compiled from ``csrc/index_helpers.cpp`` (timed), and
    ``build_mapping`` (target 509, short windows 0.1),
    ``build_sample_idx`` (512, documents shuffled) and
    ``build_blending_indices`` (the two, 0.7 / 0.3) timed over it; the
    last two held to their plain versions bitwise, the windows to their
    documents. Returns ``(corpus, report)``."""
    import numpy as np
    from fengshen_tpu_torch.data.megatron_dataloader import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder, helpers)
    from fengshen_tpu_torch.data.megatron_dataloader.gpt_dataset import \
        sequence_order

    t_phase = time.perf_counter()
    failures = []
    rng = np.random.RandomState(17)
    t0 = time.perf_counter()
    counts = rng.randint(*IDX_SENTS, IDX_DOCS)
    sizes = rng.randint(*IDX_SENT_LEN, int(counts.sum())).astype(np.int32)
    vocab = json.loads(ERLANGSHEN_CONFIG.read_text())["vocab_size"]
    tokens = rng.randint(MLMTokenizer.FIRST_CHAR, vocab,
                         int(sizes.sum()), dtype=np.int32)
    made_s = time.perf_counter() - t0
    prefix = str(workdir / "corpus")
    t0 = time.perf_counter()
    builder = MMapIndexedDatasetBuilder(prefix)
    builder.add_items(tokens, sizes)
    builder.end_documents(counts)
    builder.finalize()
    write_s = time.perf_counter() - t0
    del tokens
    corpus = MMapIndexedDataset(prefix)
    n_tokens = int(np.asarray(corpus.sizes, np.int64).sum())
    corpus_gb = (Path(prefix + ".bin").stat().st_size +
                 Path(prefix + ".idx").stat().st_size) / 1e9
    if len(corpus.doc_idx) - 1 != IDX_DOCS or n_tokens < IDX_MIN_TOKENS:
        failures.append(f"corpus: {len(corpus.doc_idx) - 1} documents, "
                        f"{n_tokens} tokens")

    lib = helpers.build(force=True)
    compile_s = helpers.last_build_seconds
    helpers.load()
    docs = np.asarray(corpus.doc_idx, np.int64)
    all_sizes = np.asarray(corpus.sizes, np.int32)
    t0 = time.perf_counter()
    maps = helpers.build_mapping(docs, all_sizes, IDX_SEQ - 3, IDX_SHORT,
                                 1234)
    mapping_s = time.perf_counter() - t0
    doc_of = np.searchsorted(docs, maps[:, 0], side="right") - 1
    windows_ok = bool(len(maps) and (maps[:, 1] <= docs[doc_of + 1]).all()
                      and (maps[:, 1] - maps[:, 0] >= 2).all() and
                      (maps[:, 2] <= IDX_SEQ - 3).all() and
                      (maps[:, 2] >= 2).all())
    short = float((maps[:, 2] < IDX_SEQ - 3).mean()) if len(maps) else 0.0
    if not windows_ok:
        failures.append("build_mapping: a window leaves its document or "
                        "its target exceeds 509")

    order = sequence_order(docs, np.random.RandomState(1234).permutation(
        IDX_DOCS).astype(np.int32))
    args = (all_sizes, order, IDX_SEQ, 1, n_tokens)
    t0 = time.perf_counter()
    sample_idx = helpers.build_sample_idx(*args)
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample_plain = helpers.build_sample_idx_plain(*args)
    sample_plain_s = time.perf_counter() - t0
    if not np.array_equal(sample_idx, sample_plain):
        failures.append("build_sample_idx differs from its plain version")
    size = len(maps) + len(sample_idx) - 1
    t0 = time.perf_counter()
    blend = helpers.build_blending_indices(list(IDX_WEIGHTS), size)
    blend_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blend_plain = helpers.build_blending_indices_plain(list(IDX_WEIGHTS),
                                                      size)
    blend_plain_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(blend, blend_plain)):
        failures.append("build_blending_indices differs from its plain "
                        "version")
    share = float((blend[0] == 0).mean())
    report = {
        "documents": len(corpus.doc_idx) - 1, "sentences": len(corpus),
        "tokens": n_tokens, "corpus_gb": corpus_gb, "made_s": made_s,
        "write_s": write_s, "library": lib.name, "compile_s": compile_s,
        "build_mapping_s": mapping_s, "windows": len(maps),
        "short_window_share": short, "windows_inside_documents": windows_ok,
        "build_sample_idx_s": sample_s,
        "build_sample_idx_plain_s": sample_plain_s,
        "gpt_samples": len(sample_idx) - 1,
        "build_blending_indices_s": blend_s,
        "build_blending_indices_plain_s": blend_plain_s,
        "blend_size": size, "blend_share_first": share}
    say("index_builders", card=card, **report,
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("index_builders: " + "; ".join(failures))
    return corpus, report


def mlm_fit(workdir: Path, name: str, card, main_fn, module_cls, model_cls,
            cfg, raw: dict, segmenter: dict, make_collator, rng,
            extra=(), profile=False) -> dict:
    """One MLM fit of the phase: the batch reckoned for MLM_BATCH rows on
    a probe model of the fit's geometry, MLM_STEPS steps of it through
    ``main_fn`` with the shell's ``extra`` flags, then the bf16 MLM
    logits held to fp32 compute on the trained weights, over 8 rows of
    the fit's collator, the most padded first. Returns the report with
    the trainer and those rows in it (``_trainer``, ``_check``) for the
    caller (:func:`check_initial_bar` takes the rows)."""
    import numpy as np
    import torch
    tok = MLMTokenizer(cfg.vocab_size)
    model_dir = config_dir(workdir / f"{name}_model", raw)
    probe_rows = mlm_records(max(PROBE_ROWS), rng)
    probe_model = model_cls(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(17))
    from fengshen_tpu_torch.examples.pretrain_bert.pretrain_bert import \
        pretrain_parser
    probe_args = pretrain_parser(module_cls).parse_args(
        ["--model_path", str(model_dir)])
    plan = reckon_batch(module_cls(probe_args, probe_model, cfg),
                        lambda n: make_collator(tok)(probe_rows[:n]),
                        MLM_BATCH)
    del probe_model
    gc.collect()
    torch.cuda.empty_cache()
    batch = plan["batch"]
    train = write_jsonl(workdir / f"{name}_train.json",
                        mlm_records(MLM_STEPS * batch, rng))
    argv = mlm_argv(workdir, name, model_dir, train, MLM_STEPS, batch,
                    extra)
    if profile:
        argv += ["--profile_steps", ",".join(map(str, MLM_PROFILE))]
    trainer, fit_s = run_fit(main_fn, argv, tokenizer=tok, **segmenter)
    profiled = set(range(MLM_PROFILE[0] + 1, MLM_PROFILE[1] + 1)) \
        if profile else set()
    report = fit_report(trainer, batch * MLM_SEQ,
                        profiled | ({MLM_PROFILE[1] + 1} if profile
                                    else set()))
    report.update(batch=batch, memory_plan=plan, fit_s=fit_s)
    if profile:
        report["profile"] = step_profile(trainer, profiled)
    model = trainer.state.model
    rows = make_collator(tok)(mlm_records(32, np.random.RandomState(170)))
    most_padded = np.argsort(rows["attention_mask"].sum(1),
                             kind="stable")[:8]
    check = to_card({k: v[most_padded] for k, v in rows.items()})
    bar = mlm_bf16_bar(model, check)
    report.update(bf16_vs_fp32_rel_l2=bar["rel_l2"],
                  trained_mask_dropped_rel_l2=bar["mask_dropped_rel_l2"],
                  bf16_rtol=CLS_BF16_RTOL, bf16_rows_pad_share=1.0 -
                  check["attention_mask"].float().mean().item())
    losses = report["losses"]
    report["failures"] = []
    if len(losses) != MLM_STEPS or not report["losses_finite"] or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        report["failures"].append(f"losses {losses}")
    if bar["rel_l2"] > CLS_BF16_RTOL:
        report["failures"].append(
            f"bf16 vs fp32 logits rel L2 {bar['rel_l2']} (limit "
            f"{CLS_BF16_RTOL})")
    report["_trainer"], report["_check"] = trainer, check
    return report


def check_initial_bar(report: dict, model_cls, cfg) -> None:
    """The bar on the fit's step-0 weights into ``report``: bf16 within
    RD_BF16_RTOL of fp32 (phase 15's bar for a freshly drawn deep stack:
    every one of its 24 layers mixes context, so bf16 rounding compounds
    to about 1.6e-2 at step 0 on an H100, four times the trained model's;
    PERF.md §6), and the dropped mask beyond it."""
    bar = initial_weights_bar(model_cls, cfg, report.pop("_check"))
    report.update(initial_bf16_vs_fp32_rel_l2=bar["rel_l2"],
                  initial_mask_dropped_rel_l2=bar["mask_dropped_rel_l2"],
                  initial_bf16_rtol=RD_BF16_RTOL)
    if bar["rel_l2"] > RD_BF16_RTOL or \
            bar["mask_dropped_rel_l2"] <= RD_BF16_RTOL:
        report["failures"].append(
            f"step-0 weights: bf16 vs fp32 logits rel L2 {bar['rel_l2']} "
            f"(limit {RD_BF16_RTOL}); mask dropped "
            f"{bar['mask_dropped_rel_l2']}")


def phase_mlm_pretrain(workdir: Path, card):
    """17a-17d: the index builders at corpus scale
    (:func:`phase_index_builders`); then ``pretrain_erlangshen.main``
    with the flags of ``pretrain_erlangshen_base.sh`` (``--max_seq_length
    512 --masked_lm_prob 0.15 --scheduler_type polynomial --warmup_ratio
    0.01 --learning_rate 1e-4``, ``--fsdp_parallel_size`` 1 on one card)
    on Erlangshen-MegatronBert-1.3B at all 24 layers, MLM_STEPS steps of
    the shell's 32 rows of 512 or what the memory probe allows, steps 5-6
    profiled, the bf16 bar on the trained and the step-0 weights
    (:func:`check_initial_bar`), and two more steps whose rows come from
    a ``BertDataset`` over 17a's corpus; ``pretrain_deberta.main`` with
    ``pretrain_deberta_base.sh``'s flags on Erlangshen-DeBERTa-v2-710M
    at all 24 layers likewise (MFU from :func:`deberta_flops_per_token`);
    ``pretrain_bert.main`` with ``pretrain_bert.sh``'s flags on
    bert-base-chinese, 32 x 512, BB_STEPS steps with a checkpoint after
    MLM_CKPT_AT, resumed from it: the resumed step's loss equals the
    uninterrupted run's. Words are cut two characters a word (the card's
    machine has no ``jieba``). K1-K4 launch 0 times."""
    import shutil

    import numpy as np
    import torch
    from fengshen_tpu_torch.data.megatron_dataloader import BertDataset
    from fengshen_tpu_torch.examples.pretrain_bert import pretrain_bert
    from fengshen_tpu_torch.examples.pretrain_erlangshen_bert import \
        pretrain_erlangshen
    from fengshen_tpu_torch.examples.pretrain_erlangshen_deberta_v2 import \
        pretrain_deberta
    from fengshen_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from fengshen_tpu_torch.models.deberta_v2 import (DebertaV2Config,
                                                      DebertaV2ForMaskedLM)
    from fengshen_tpu_torch.models.megatron_bert import (
        MegatronBertConfig, MegatronBertForPreTraining)
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts

    free, disk = check_room("mlm_pretrain", workdir, MLM_MIN_FREE_GIB,
                            MLM_MIN_DISK_GIB)
    t_phase = time.perf_counter()
    reset_launch_counts()
    failures = []
    geometry = {}
    for name, cls, cfg_cls, path, want, layers in (
            ("erlangshen", MegatronBertForPreTraining, MegatronBertConfig,
             ERLANGSHEN_CONFIG, MB_PARAMS, 24),
            ("deberta", DebertaV2ForMaskedLM, DebertaV2Config,
             DEBERTA_CONFIG, DEB_PARAMS, 24),
            ("bert", BertForMaskedLM, BertConfig, BERT_BASE_CONFIG,
             BB_PARAMS, 12)):
        cfg = cfg_cls.from_pretrained(str(path))
        n = count_params(cls, cfg)
        geometry[name] = {"config": path.name, "n_params": n,
                          "layers": cfg.num_hidden_layers}
        if n != want or cfg.num_hidden_layers != layers:
            raise AssertionError(f"mlm_pretrain: {name} has {n} parameters"
                                 f" and {cfg.num_hidden_layers} layers "
                                 f"(want {want}, {layers})")
    corpus, index_report = phase_index_builders(workdir, card)
    rng = np.random.RandomState(17)
    words = {"zh_tokenizer": two_char_words}

    # 17b: Erlangshen-MegatronBert-1.3B, MLM + SOP
    cfg = MegatronBertConfig.from_pretrained(str(ERLANGSHEN_CONFIG))
    mb = mlm_fit(
        workdir, "erlangshen", card, pretrain_erlangshen.main,
        pretrain_erlangshen.ErLangShenBert, MegatronBertForPreTraining, cfg,
        json.loads(ERLANGSHEN_CONFIG.read_text()), words,
        lambda tok: pretrain_erlangshen.ErLangShenCollator(
            tok, MLM_SEQ, zh_tokenizer=two_char_words), rng,
        extra=("--scheduler_type", "polynomial", "--warmup_ratio", 0.01,
               "--learning_rate", 1e-4, "--fsdp_parallel_size", 1,
               "--every_n_train_steps", 1000),
        profile=True)
    trainer = mb.pop("_trainer")
    history = [e for e in trainer.history if "step_time_s" in e]
    mb["mlm_loss"] = [e["mlm_loss"] for e in history]
    mb["sop_loss"] = [e["sop_loss"] for e in history]
    mb["mlm_acc"] = [e["mlm_acc"] for e in history]
    # two more steps on rows of a BertDataset over 17a's corpus
    t0 = time.perf_counter()
    dataset = BertDataset(corpus, MLMTokenizer(cfg.vocab_size), MLM_SEQ,
                          0.15, IDX_SHORT, seed=1234,
                          zh_tokenizer=two_char_words)
    module = pretrain_erlangshen.ErLangShenBert(trainer.args,
                                                trainer.state.model, cfg)
    optimizer = trainer.state.optimizer
    extra_losses, keys = [], None
    for step in range(2):
        rows = [dataset[step * mb["batch"] + i] for i in range(mb["batch"])]
        batch = to_card({k: np.stack([r[k] for r in rows])
                         for k in rows[0]})
        keys = {k: list(v.shape) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        loss, _ = module.training_loss(batch)
        loss.backward()
        optimizer.step()
        extra_losses.append(loss.item())
    torch.cuda.synchronize()
    mb.update(bert_dataset_windows=len(dataset),
              bert_dataset_batch=keys, bert_dataset_losses=extra_losses,
              bert_dataset_s=time.perf_counter() - t0)
    if not np.isfinite(extra_losses).all():
        mb["failures"].append(f"BertDataset steps: {extra_losses}")
    del trainer, module, optimizer, dataset
    gc.collect()
    torch.cuda.empty_cache()
    check_initial_bar(mb, MegatronBertForPreTraining, cfg)

    # 17c: Erlangshen-DeBERTa-v2-710M, MLM
    cfg = DebertaV2Config.from_pretrained(str(DEBERTA_CONFIG))
    deb = mlm_fit(
        workdir, "deberta", card, pretrain_deberta.main,
        pretrain_deberta.DebertaPretrainModule, DebertaV2ForMaskedLM, cfg,
        json.loads(DEBERTA_CONFIG.read_text()), words,
        lambda tok: pretrain_deberta.DeBERTaV2Collator(
            tok, MLM_SEQ, zh_tokenizer=two_char_words), rng,
        extra=("--learning_rate", 1e-4, "--warmup_steps", PT_WARMUP,
               "--precision", "bf16", "--every_n_train_steps", 5000))
    deb.pop("_trainer")
    gc.collect()
    torch.cuda.empty_cache()
    check_initial_bar(deb, DebertaV2ForMaskedLM, cfg)
    fpt = deberta_flops_per_token(cfg, MLM_SEQ)
    deb.update(flops_per_token=fpt, flops_per_token_logged=deb[
        "flops_per_token"], mfu=fpt * deb["tokens_per_s"] / BF16_FLOPS)
    gc.collect()
    torch.cuda.empty_cache()

    # 17d: bert-base-chinese whole-word masking; a checkpoint and its
    # resume
    cfg = BertConfig.from_pretrained(str(BERT_BASE_CONFIG))
    tok = MLMTokenizer(cfg.vocab_size)
    model_dir = config_dir(workdir / "bert_model",
                           json.loads(BERT_BASE_CONFIG.read_text()))
    train = write_jsonl(workdir / "bert_train.json",
                        mlm_records(BB_STEPS * MLM_BATCH, rng))
    argv = mlm_argv(workdir, "bert", model_dir, train, BB_STEPS, MLM_BATCH,
                    ("--learning_rate", 1e-4, "--warmup_steps", PT_WARMUP,
                     "--precision", "bf16", "--every_n_train_steps",
                     MLM_CKPT_AT))
    trainer, fit_s = run_fit(pretrain_bert.main, argv, tokenizer=tok,
                             word_cuter=two_char_words)
    bb = fit_report(trainer, MLM_BATCH * MLM_SEQ)
    whole = {e["step"]: e["loss"] for e in trainer.history
             if "step_time_s" in e}
    io = dict(next(c for c in trainer.callbacks if hasattr(c, "stats"))
              .stats)
    del trainer
    saved = sorted(p.name for p in (workdir / "bert" / "ckpt").iterdir())
    resumed, resume_s = run_fit(pretrain_bert.main, argv, tokenizer=tok,
                                word_cuter=two_char_words)
    again = {e["step"]: e["loss"] for e in resumed.history
             if "step_time_s" in e}
    rio = next(c for c in resumed.callbacks if hasattr(c, "stats")).stats
    del resumed
    bb.update(batch=MLM_BATCH, fit_s=fit_s, checkpoints=saved,
              ckpt_gib_written=io["bytes_written"] / 2**30,
              ckpt_write_gib_per_s=io["bytes_written"] / 2**30 /
              max(io["save_s"], 1e-9), resume_s=resume_s,
              ckpt_gib_read=rio["bytes_read"] / 2**30,
              resumed_losses=again,
              resumed_step_equal=again == {BB_STEPS: whole.get(BB_STEPS)})
    bb["failures"] = []
    if saved != [str(MLM_CKPT_AT)] or not bb["resumed_step_equal"] or \
            not bb["losses_finite"] or len(bb["losses"]) != BB_STEPS:
        bb["failures"].append(f"checkpoints {saved}, uninterrupted "
                              f"{whole}, resumed {again}")
    shutil.rmtree(workdir / "bert" / "ckpt")
    gc.collect()
    torch.cuda.empty_cache()

    launches = kernel_launches()
    if any(launches.values()):
        failures.append(f"kernel launches on the MLM paths: {launches}")
    for name, report in (("erlangshen_1.3b", mb), ("deberta_v2_710m", deb),
                         ("bert_base", bb)):
        fails = report.pop("failures")
        failures += [f"{name}: {f}" for f in fails]
        say(f"mlm_pretrain_{name}", card=card, **geometry[
            name.split("_")[0]], seq=MLM_SEQ, shell_batch=MLM_BATCH,
            **report)
    say("mlm_pretrain", card=card, device_free_gib=free, disk_free_gib=disk,
        index_builders=index_report, kernel_launches=launches,
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("mlm_pretrain: " + "; ".join(failures))


# -- phase 18 -------------------------------------------------------------

#: phase 18: Taiyi Stable Diffusion at full SD-1.x width. The text tower
#: is BERT-base (IDEA-CCNL/Taiyi-Stable-Diffusion-1B-Chinese-v0.1's
#: text_encoder: hidden 768, 12 layers, 12 heads, FFN 3072, vocab 21128);
#: the UNet and VAE are SDUNetConfig's and SDVAEConfig's defaults (its
#: unet/ and vae/). Everything runs in fp32 (TF32 off, as the whole smoke
#: runs), so MFU is taken against FP32_FLOPS.
SD_TEXT = dict(vocab_size=21128, hidden_size=768, num_hidden_layers=12,
               num_attention_heads=12, intermediate_size=3072,
               max_position_embeddings=512, dtype="float32")
SD_IMAGE, SD_SEQ = 512, 77
#: rows wanted per step (the probe may cut them), steps, the profiled
#: step (--profile_steps 3,4 traces step 4; steps 2-3 give the step time)
SD_BATCH, SD_STEPS, SD_PROFILE = 8, 4, (3, 4)
#: the demo's denoise steps: 20, not the demo's 50, for the time limit
SD_SAMPLE_STEPS, SD_GUIDANCE = 20, 7.5
#: the serving pipeline's steps and the engine's batch
SD_SERVE_STEPS, SD_SERVE_BATCH = 4, 2
#: a small SD-1.x forward on the card against the same on the CPU, fp32
#: with TF32 off: the products differ only in summation order (~1e-6)
SD_CPU_RTOL = 1e-4
SD_MIN_FREE_GIB = 60
SD_UNET_PARAMS = 859_520_964
SD_VAE_PARAMS = 83_653_863


class CaptionTokenizer:
    """One id per character, BERT-Chinese style: ``[CLS]`` 101 ... ``[SEP]``
    102, characters in [106, vocab), padding 0; the collator's HF-style
    call and the demo's and the pipeline's ``encode``."""

    pad_token_id = 0

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str) -> list:
        return [101] + [106 + ord(c) % (self.vocab - 106)
                        for c in text] + [102]

    def __call__(self, texts, padding=None, truncation=None,
                 max_length=None, return_tensors=None):
        import numpy as np
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = self.encode(text)[:max_length]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def sd_samples(n: int, rng) -> list:
    """Caption + decoded-image samples made from a seed (the card's
    machine has no Pillow): smooth colour fields in [0, 1]."""
    import numpy as np
    chars = "一只橘猫坐在窗台上看雨山水画中的小船飞流直下三千尺油画"
    out = []
    yy, xx = np.mgrid[0:SD_IMAGE, 0:SD_IMAGE].astype(np.float32) / SD_IMAGE
    for _ in range(n):
        a, b, c = rng.uniform(0.5, 4.0, 3)
        img = np.stack([0.5 + 0.5 * np.sin(a * np.pi * xx + c),
                        0.5 + 0.5 * np.cos(b * np.pi * yy),
                        0.5 + 0.5 * np.sin(a * xx * yy * np.pi * b)], -1)
        caption = "".join(rng.choice(list(chars), rng.randint(6, 30)))
        out.append({"caption": caption,
                    "pixels": img.astype(np.float32)})
    return out


def sd_small_cuda_vs_cpu() -> dict:
    """The SD-1.x test towers' ``__call__`` and ``decode_image`` on the
    card against the same weights and inputs on the CPU."""
    import numpy as np
    import torch
    from fengshen_tpu_torch.models.bert import BertConfig
    from fengshen_tpu_torch.models.stable_diffusion import (
        SDUNetConfig, SDVAEConfig, TaiyiStableDiffusion)
    text = BertConfig.small_test_config(dtype="float32",
                                        hidden_dropout_prob=0.0,
                                        attention_probs_dropout_prob=0.0)
    cpu = TaiyiStableDiffusion(text, SDVAEConfig.small_test_config(),
                               SDUNetConfig.small_test_config(),
                               device="cpu",
                               generator=torch.Generator().manual_seed(5))
    card = TaiyiStableDiffusion(text, SDVAEConfig.small_test_config(),
                                SDUNetConfig.small_test_config(),
                                device="cuda", init=False)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(18)
    ids = torch.tensor(rng.randint(3, 128, (2, 8)))
    pixels = torch.tensor(rng.uniform(-1, 1, (2, 3, 32, 32)),
                          dtype=torch.float32)
    t = torch.tensor([3, 900])
    noise, post = (torch.tensor(rng.randn(2, 4, 16, 16),
                                dtype=torch.float32) for _ in range(2))

    def run(model, dev):
        with torch.no_grad():
            pred, lat = model(ids.to(dev), pixels.to(dev), t.to(dev),
                              noise.to(dev), posterior_noise=post.to(dev))
            return pred.cpu(), model.decode_image(lat).cpu()

    want, got = run(cpu, "cpu"), run(card, "cuda")
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    return {"pred_rel_l2": rel[0], "decode_rel_l2": rel[1],
            "rtol": SD_CPU_RTOL}


def sd_step_flops(module, batch: dict) -> dict:
    """FLOPs of one training step at ``batch``'s rows, from
    ``FlopCounterMode`` over one row (every op is linear in the rows):
    the whole step (VAE encode and text tower without autograd, UNet
    forward and backward, the loss), and the UNet's forward and backward
    alone on that row's shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    rows = batch["pixel_values"].shape[0]
    one = {k: v[:1] for k, v in batch.items()}
    model = module.model
    with FlopCounterMode(display=False) as step:
        loss, _ = module.training_loss(one)
        loss.backward()
    shape = (1,) + tuple(model.vae_config.latent_shape(
        one["pixel_values"].shape[2]))
    with torch.no_grad():
        text = model.encode_text(one["input_ids"], one["attention_mask"])
    noisy = torch.randn(shape, device=text.device)
    with FlopCounterMode(display=False) as unet:
        pred = model.unet(noisy, torch.tensor([500], device=text.device),
                          text)
        pred.float().square().mean().backward()
    for p in model.parameters():
        p.grad = None
    return {"step_flops": step.get_total_flops() * rows,
            "unet_flops": unet.get_total_flops() * rows,
            "flops_counted_at_rows": 1, "rows": rows}


def phase_taiyi_sd(workdir: Path, card):
    """18: Taiyi Stable Diffusion at full SD-1.x width and depth. (a) the
    SD-1.x test towers on the card against the CPU; (b)
    ``finetune.main`` with ``--faithful_towers`` for SD_STEPS steps of
    512 px images and 77-token captions made from a seed, the batch by
    the memory probe, step 3 profiled: losses finite, the UNet moved, the
    text tower and VAE bitwise unchanged; step time, peak memory, the
    step's FLOPs (``FlopCounterMode``), MFU against FP32_FLOPS, idle
    share; (c) ``demo.main`` on the trained module at 512 px, CFG 7.5,
    SD_SAMPLE_STEPS steps; (d) the module behind ``Pipeline``
    (SD_SERVE_STEPS steps), ``BatchImageEngine(max_batch=2)`` and the
    stdlib server: ``/healthz`` 503 then 200, three concurrent POSTs of
    [512, 512, 3] uint8 images, a batch of 2 in ``/stats``, the drain.
    No checkpoint is written on the card (the CPU tests pin save and
    resume). K1-K4 launch 0 times."""
    import base64
    from unittest import mock

    import numpy as np
    import torch
    from fengshen_tpu_torch.api.main import (PipelineConfig, ServerConfig,
                                             _start_warmup_thread,
                                             build_stdlib_server, drain)
    from fengshen_tpu_torch.data.clip_dataloader import SDCollator
    from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
        import finetune
    from fengshen_tpu_torch.examples.stable_diffusion_chinese import demo
    from fengshen_tpu_torch.models.bert import BertConfig
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.pipelines.image_generation import Pipeline
    from fengshen_tpu_torch.serving import BatchImageEngine

    t_phase = time.perf_counter()
    failures = []
    free, disk = check_room("taiyi_sd", workdir, SD_MIN_FREE_GIB, 1)
    reset_launch_counts()
    small = sd_small_cuda_vs_cpu()
    if max(small["pred_rel_l2"], small["decode_rel_l2"]) > SD_CPU_RTOL:
        failures.append(f"small towers, card vs CPU: {small}")

    text_dir = workdir / "taiyi_text"
    BertConfig(**SD_TEXT).save_pretrained(str(text_dir))
    tok = CaptionTokenizer(SD_TEXT["vocab_size"])
    rng = np.random.RandomState(18)
    argv = [str(x) for x in (
        "--model_path", text_dir, "--faithful_towers", "--image_size",
        SD_IMAGE, "--max_length", SD_SEQ, "--learning_rate", 1e-5,
        "--weight_decay", 0.1, "--warmup_steps", 0, "--scheduler_type",
        "constant", "--log_every_n_steps", 1, "--seed", 1234,
        "--default_root_dir", workdir / "taiyi_runs", "--device", "cuda",
        *no_checkpoints(workdir / "taiyi_ckpt"))]
    # (b) the memory probe on a model of the fit's geometry
    probe_args = finetune.parser().parse_args(argv)
    probe = finetune.TaiyiSDModule(probe_args, device="cuda")
    probe.init_params(torch.Generator(device="cuda").manual_seed(17))
    n_params = {name: sum(p.numel() for p in getattr(probe.model, name)
                          .parameters())
                for name in ("unet", "vae", "text_encoder")}
    if (n_params["unet"], n_params["vae"]) != (SD_UNET_PARAMS,
                                               SD_VAE_PARAMS):
        raise AssertionError(f"taiyi_sd: parameter counts {n_params}")
    collate = SDCollator(tok, image_size=SD_IMAGE, max_length=SD_SEQ)
    probe_rows = sd_samples(max(PROBE_ROWS), rng)
    plan = reckon_batch(probe, lambda n: collate(probe_rows[:n]), SD_BATCH)
    del probe
    batch = plan["batch"]
    samples = sd_samples(batch * SD_STEPS, rng)
    snapshot = {}
    real_init = finetune.TaiyiSDModule.init_params

    def init_and_snapshot(module, generator):
        model = real_init(module, generator)
        snapshot["module"] = module
        snapshot["towers"] = {k: v.clone() for k, v in model.state_dict()
                              .items() if not k.startswith("unet.")}
        snapshot["unet"] = {k: v.clone() for k, v in list(
            model.unet.state_dict().items())[::97]}
        return model

    with mock.patch.object(finetune.TaiyiSDModule, "init_params",
                           init_and_snapshot):
        trainer, fit_s = run_fit(finetune.main, argv + [
            "--train_batchsize", str(batch), "--max_steps", str(SD_STEPS),
            "--profile_steps", ",".join(map(str, SD_PROFILE))],
            tokenizer=tok, datasets={"train": samples})
    model = trainer.state.model
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = [e for e in trainer.history if "loss" in e and
             "step_time_s" in e]
    losses = [e["loss"] for e in steps]
    profiled = set(range(SD_PROFILE[0] + 1, SD_PROFILE[1] + 1))
    step_s = float(np.median([e["step_time_s"] for e in steps
                              if e["step"] >= 2 and
                              e["step"] not in profiled]))
    state = model.state_dict()
    towers_same = all(torch.equal(state[k], v)
                      for k, v in snapshot["towers"].items())
    unet_moved = sum(not torch.equal(model.unet.state_dict()[k], v)
                     for k, v in snapshot["unet"].items())
    module = snapshot.pop("module")
    del snapshot
    for p in model.parameters():
        p.grad = None
    trainer.state.optimizer = None
    gc.collect()
    torch.cuda.empty_cache()
    check = {k: torch.as_tensor(v).to("cuda")
             for k, v in collate(samples[:batch]).items()}
    flops = sd_step_flops(module, check)
    del check
    train = {
        "steps": len(steps), "batch": batch, "memory_plan": plan,
        "fit_s": fit_s, "step1_s": steps[0]["step_time_s"],
        "step_time_s_median": step_s,
        "step_time_s": [e["step_time_s"] for e in steps],
        "images_per_s": batch / step_s, "losses": losses,
        "peak_memory_gib": peak_gib, **flops,
        "unet_mfu_fp32": flops["unet_flops"] / step_s / FP32_FLOPS,
        "step_mfu_fp32": flops["step_flops"] / step_s / FP32_FLOPS,
        "fp32_peak_flops": FP32_FLOPS,
        "profile": step_profile(trainer, profiled),
        "towers_bitwise_unchanged": towers_same,
        "unet_sampled_tensors_moved":
            f"{unet_moved}/{len(range(0, len(model.unet.state_dict()), 97))}",
        "params": n_params}
    if len(losses) != SD_STEPS or not np.isfinite(losses).all():
        failures.append(f"losses {losses}")
    if not towers_same:
        failures.append("the frozen text tower or VAE changed")
    if unet_moved == 0:
        failures.append("the UNet did not move")
    ckpt_files = [str(f) for f in (workdir / "taiyi_ckpt").rglob("*")
                  if f.is_file()]
    train["checkpoint_files"] = len(ckpt_files)
    if ckpt_files:
        failures.append(f"the fit wrote a checkpoint: {ckpt_files[:3]}")

    # (c) the demo on the trained module
    marks = []

    def mark_step(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = demo.main(["--prompt", "飞流直下三千尺，油画",
                        "--guidance_scale", str(SD_GUIDANCE), "--out",
                        str(workdir / "taiyi.png")], model=model,
                       tokenizer=tok, image_size=SD_IMAGE,
                       num_steps=SD_SAMPLE_STEPS,
                       generator=torch.Generator().manual_seed(0),
                       step_callback=mark_step)
    sample_s = time.perf_counter() - t0
    step_ms = np.diff([t0] + marks) * 1e3
    sampling = {"steps": SD_SAMPLE_STEPS, "guidance_scale": SD_GUIDANCE,
                "image_shape": list(images.shape), "total_s": sample_s,
                "denoise_ms_per_step_median": float(np.median(step_ms[1:])),
                "first_step_ms": float(step_ms[0]),
                "text_and_decode_s": sample_s - float(step_ms.sum()) / 1e3,
                "pixel_mean": float(images.mean()),
                "pixel_std": float(images.std())}
    if images.shape != (1, SD_IMAGE, SD_IMAGE, 3) or \
            not np.isfinite(images).all() or images.min() < 0 or \
            images.max() > 1:
        failures.append(f"demo image {sampling}")

    # (d) served over HTTP
    pipe = Pipeline(module=model, tokenizer=tok, image_size=SD_IMAGE,
                    num_inference_steps=SD_SERVE_STEPS, max_text_len=SD_SEQ,
                    seed=0)
    engine = BatchImageEngine(pipe, max_batch=SD_SERVE_BATCH,
                              gather_ms=500.0)
    gate, warm = threading.Event(), engine.warmup

    def gated_warmup():
        gate.wait(60)
        return warm()

    engine.warmup = gated_warmup
    server_cfg = ServerConfig(host="127.0.0.1", port=0,
                              engine="batch_image", request_timeout_s=300)
    pipe_cfg = PipelineConfig(task="image_generation")
    ready = _start_warmup_thread(server_cfg, pipe_cfg, pipe, engine)
    draining = threading.Event()
    server = build_stdlib_server(server_cfg, pipe_cfg, pipeline=pipe,
                                 engine=engine, ready=ready,
                                 draining=draining)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    serving = {}
    try:
        serving["healthz_before_warmup"] = http_json(port, "/healthz")[0]
        gate.set()
        if not ready.wait(300):
            raise AssertionError("taiyi_sd: the engine never warmed up")
        serving["healthz_after_warmup"] = http_json(port, "/healthz")[0]
        serving["warmup_s"] = engine.stats()["warmup_s"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            answers = list(pool.map(lambda i: http_json(
                port, "/api/image_generation",
                {"input_text": f"第{i}幅山水画", "request_id": f"sd-{i}"}),
                range(3)))
        serving["three_requests_s"] = time.perf_counter() - t0
        shapes = []
        for code, body in answers:
            raw = base64.b64decode(body["result"]["image_b64"]) \
                if code == 200 else b""
            shapes.append((code, body.get("engine_type"),
                           body.get("result", {}).get("shape"),
                           body.get("result", {}).get("dtype"), len(raw)))
        serving["answers"] = shapes
        stats = http_json(port, "/stats")[1]
        serving["stats"] = {k: stats[k] for k in (
            "requests_total", "batches_total", "avg_batch", "max_batch")}
        # the drain, with one request in flight
        pool = concurrent.futures.ThreadPoolExecutor(1)
        inflight = pool.submit(http_json, port, "/api/image_generation",
                               {"input_text": "最后一幅"})
        deadline = time.monotonic() + 60
        while engine.idle() and time.monotonic() < deadline:
            time.sleep(0.005)
        waiter = drain(server, draining, engine=engine,
                       drain_timeout_s=120, poll_s=0.01)
        late = http_json(port, "/api/image_generation",
                         {"input_text": "太晚了"})
        serving["late_post"] = [late[0], late[1].get("reason")]
        serving["inflight_post"] = inflight.result(300)[0]
        pool.shutdown()
        waiter.join(300)
        serving["drained"] = not waiter.is_alive()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    want = [(200, "batch_image", [SD_IMAGE, SD_IMAGE, 3], "uint8",
             SD_IMAGE * SD_IMAGE * 3)] * 3
    if serving["healthz_before_warmup"] != 503 or \
            serving["healthz_after_warmup"] != 200 or \
            serving["answers"] != want or \
            serving["stats"]["batches_total"] != 2 or \
            serving["stats"]["avg_batch"] != 1.5 or \
            serving["late_post"] != [503, "draining"] or \
            serving["inflight_post"] != 200 or not serving["drained"]:
        failures.append(f"serving {serving}")
    launches = kernel_launches()
    if any(launches.values()):
        failures.append(f"kernel launches on the SD paths: {launches}")
    say("taiyi_sd_small_card_vs_cpu", card=card, **small)
    say("taiyi_sd_train", card=card, image=SD_IMAGE, seq=SD_SEQ,
        text=SD_TEXT, **train)
    say("taiyi_sd_sample", card=card, image=SD_IMAGE, **sampling)
    say("taiyi_sd_serve", card=card, steps=SD_SERVE_STEPS, **serving)
    del model, trainer, pipe, module
    gc.collect()
    torch.cuda.empty_cache()
    say("taiyi_sd", card=card, device_free_gib=free, disk_free_gib=disk,
        kernel_launches=launches, phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("taiyi_sd: " + "; ".join(failures))


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
    with tempfile.TemporaryDirectory() as tmp:
        phase_classification(Path(tmp), card)
        mark("12_classification")
    with tempfile.TemporaryDirectory() as tmp:
        wz_launches, wz_rows = phase_wenzhong(Path(tmp), card)
        mark("13_wenzhong")
    with tempfile.TemporaryDirectory() as tmp:
        phase_randeng(Path(tmp), card)
        mark("14_randeng")
    with tempfile.TemporaryDirectory() as tmp:
        phase_randeng_pretrain(Path(tmp), card)
        mark("15_randeng_pretrain")
    with tempfile.TemporaryDirectory() as tmp:
        phase_seq2seq_families(Path(tmp), card)
        mark("16_seq2seq_families")
    with tempfile.TemporaryDirectory() as tmp:
        phase_mlm_pretrain(Path(tmp), card)
        mark("17_mlm_pretrain")
    with tempfile.TemporaryDirectory() as tmp:
        phase_taiyi_sd(Path(tmp), card)
        mark("18_taiyi_sd")
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
        by_path = {"long_context": long_launches[name],
                   "wenzhong_3.5b": wz_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": long_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "variant": "tensor_core", "launches_by_path": by_path})
    # the same kernels at Wenzhong's shape (T 511, H 3072, V 50304):
    # launches from phase 13's K2 run, times from its K2 check
    for name in K2_NAMES:
        e, r = get_entry(name), wz_rows[name]
        kernels.append({
            "name": f"{name}_wenzhong", "route": "cuda", "source": e.source,
            "replaces": e.replaces, "launches": wz_launches[name],
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
