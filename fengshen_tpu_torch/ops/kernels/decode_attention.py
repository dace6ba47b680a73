"""Paged decode attention: kernel K3, the port of
``fengshen_tpu/ops/pallas/decode_attention.py``.

- :func:`decode_attention` is the seam every decode shape routes
  through (``decode_attention`` at ``:62`` of the reference). For a CUDA
  tensor and a query window S <= 8 it launches the hand-written kernel
  in ``fengshen_tpu_torch/csrc/decode_attention.cu``, and raises if the
  shape is outside the kernel's rules. A longer window (prefill) goes to
  the dense lowering, as the JAX seam routes it, and is counted in
  ``dense_calls``. CPU tensors take the plain version.
- :func:`cuda_decode_attention` is the kernel's wrapper: it checks
  device, dtype, shape and contiguity, allocates the output, launches on
  the current stream, raises on a non-zero launch code and counts the
  launch, per query-window length in ``KernelEntry.variants``
  (``"s1"`` for a decode tick, ``"s5"`` for a speculative verify window
  of gamma 4), so a serving run can show which windows went through it.
- :func:`torch_decode_attention` is the plain version, a copy of
  ``xla_decode_attention`` (``:117-150``): take-gather of the paged
  pool, dequantization of an int8 window, GQA repeat, then dense
  attention.

int8 pools (the int8 branch, ``:176-181``) come with fp32 per-(token,
head) scales ``k_scale``/``v_scale`` of the pool's leading shape and the
compute dtype ``dequant_dtype`` (fp32 when None). Both versions
dequantize as ``dequantize_kv`` does, ``int8 -> fp32 x scale -> rounded
to dequant_dtype``; the kernel stages the raw int8 rows and their scales
in shared memory and dequantizes as it reads them, so the pool stays
int8 in device memory and no dequantized copy of it is ever made.

The kernel's rules are its own (the 128-multiples of the TPU kernel's
``pallas_decode_eligible`` were TPU tiling rules): head_dim 64 or 128,
any paged block size that is a multiple of 8, q in bf16 or fp32, pools
in q's dtype or int8 with both fp32 scale tensors and a bf16 or fp32
``dequant_dtype``, and at most 64 query rows per KV head (H/KVH * S).

The kernel splits each lane into runs of 64-token tiles (split-K) and
combines the splits' partial softmax states in the same launch.
:func:`split_plan` is that plan, pure host code: from the lane length
and the number of (lane, KV head) pairs it picks how many splits each
pair gets, so that the grid keeps every SM of the card busy however the
lanes' lengths differ. With more than one split the wrapper hands the
kernel an fp32 workspace for the partials (allocated per call) and a
per-device int32 counter per pair (allocated once, left at 0 by every
launch): calls on one device must come from one stream at a time, as
the serving engine's do.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv
from fengshen_tpu_torch.ops.kernels import (KernelError, kernel_choice,
                                            register_kernel)

#: longest query window the kernel serves: the decode tick (1) and any
#: speculative verify window; longer windows are prefill-shaped
MAX_QUERY_WINDOW = 8
#: query rows one thread block holds (H / KVH * S), bounded by the
#: kernel's shared memory
MAX_ROWS_PER_KV_HEAD = 64
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: tokens per tile of the kernel (``kTile`` in the CUDA source)
TILE_TOKENS = 64
#: most tiles one split walks (``kMaxSplitTiles``): bounds the block-table
#: entries a split block reads into shared memory
MAX_SPLIT_TILES = 64
#: thread blocks a call aims for per SM: about three waves of the three
#: blocks an SM holds at once in bf16, so that a pair's long lane is
#: spread over several SMs and short lanes fill in behind it (at
#: chip_smoke.py's phase-3 shapes, 8 lanes x 40 KV heads of 2048
#: positions, 8 beat 16 and 32 on paged pools on an H100; PERF.md)
BLOCKS_PER_SM = 8
#: SMs of an H100 SXM; the wrapper asks the card
DEFAULT_SMS = 132


def split_plan(lane_len: int, pairs: int,
               sms: int = DEFAULT_SMS) -> Tuple[int, int]:
    """``(splits, tiles_per_split)`` for a call with ``pairs`` (lane, KV
    head) pairs of ``lane_len`` positions: each pair gets enough splits
    that the grid has about ``BLOCKS_PER_SM * sms`` blocks, never more
    splits than the lane has tiles nor a split longer than
    ``MAX_SPLIT_TILES`` tiles; every split holds at least one tile."""
    tiles = max(1, math.ceil(lane_len / TILE_TOKENS))
    want = max(1, math.ceil(BLOCKS_PER_SM * sms / max(pairs, 1)),
               math.ceil(tiles / MAX_SPLIT_TILES))
    per = math.ceil(tiles / min(want, tiles))
    return math.ceil(tiles / per), per


_SMS: Dict[int, int] = {}
_COUNTERS: Dict[int, torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _counters(device: torch.device, pairs: int) -> torch.Tensor:
    """The device's split counters, one int32 per pair, zero between
    calls (the kernel's last split block of a pair resets its own)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < pairs:
        buf = torch.zeros(max(pairs, 1024), dtype=torch.int32,
                          device=torch.device("cuda", idx))
        _COUNTERS[idx] = buf
    return buf


def _scales_given(k_scale, v_scale) -> bool:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both k_scale and v_scale "
                         "(an int8 pool) or neither")
    return k_scale is not None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     block_table: Optional[torch.Tensor] = None,
                     dequant_dtype=None) -> torch.Tensor:
    """``q [B, S, H, D]``; ``k/v`` a slot pool ``[B, L, KVH, D]`` or, with
    ``block_table [B, max_blocks]`` int32, a paged pool
    ``[num_blocks, block_size, KVH, D]``; ``valid [B, S, L]`` bool over
    the (virtual) lane; an int8 pool's fp32 scales ``k_scale``/``v_scale``
    ``[B, L, KVH]`` or ``[num_blocks, block_size, KVH]``. Returns
    ``[B, S, H, D]`` in q's dtype."""
    kw = dict(k_scale=k_scale, v_scale=v_scale, block_table=block_table,
              dequant_dtype=dequant_dtype)
    if kernel_choice("decode_attention", q) == "cuda":
        if q.shape[1] <= MAX_QUERY_WINDOW:
            return cuda_decode_attention(q, k, v, valid, **kw)
        ENTRY.dense_calls += 1
    return torch_decode_attention(q, k, v, valid, **kw)


def torch_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           block_table: Optional[torch.Tensor] = None,
                           dequant_dtype=None) -> torch.Tensor:
    """The plain version: ``xla_decode_attention`` op for op. A paged
    int8 pool is gathered first and the gathered window dequantized; a
    slot int8 pool is dequantized in place."""
    dt = torch.float32 if dequant_dtype is None else dequant_dtype
    quantized = _scales_given(k_scale, v_scale)
    if block_table is not None:
        num_blocks, block_size = k.shape[:2]
        batch = q.shape[0]
        virt_len = block_table.shape[-1] * block_size
        flat_k = k.reshape(num_blocks * block_size, *k.shape[2:])
        flat_v = v.reshape(num_blocks * block_size, *v.shape[2:])
        gather_idx = ((block_table.long() * block_size)[:, :, None] +
                      torch.arange(block_size, device=k.device)[None, None]
                      ).reshape(batch, virt_len)
        k = flat_k[gather_idx]
        v = flat_v[gather_idx]
        if quantized:
            flat_ks = k_scale.reshape(num_blocks * block_size, -1)
            flat_vs = v_scale.reshape(num_blocks * block_size, -1)
            k = dequantize_kv(k, flat_ks[gather_idx], dt)
            v = dequantize_kv(v, flat_vs[gather_idx], dt)
    elif quantized:
        k = dequantize_kv(k, k_scale, dt)
        v = dequantize_kv(v, v_scale, dt)
    n_heads, kv_heads = q.shape[2], k.shape[2]
    if kv_heads != n_heads:
        rep = n_heads // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return dot_product_attention(q, k, v, mask=valid[:, None])


def check_eligible(q, k, v, valid, block_table=None, k_scale=None,
                   v_scale=None, dequant_dtype=None) -> None:
    """Raise ``ValueError`` for anything the kernel does not take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"decode_attention kernel: {what}")

    need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
         "q/k/v must be 4-D")
    batch, s, n_heads, head_dim = q.shape
    need(1 <= s <= MAX_QUERY_WINDOW,
         f"query window S={s} outside 1..{MAX_QUERY_WINDOW}")
    need(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (bf16 or fp32 only)")
    scales = []
    if _scales_given(k_scale, v_scale):
        need(k.dtype == torch.int8 and v.dtype == torch.int8,
             f"scales given with a {k.dtype}/{v.dtype} pool (int8 only)")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            need(t.dtype == torch.float32 and
                 tuple(t.shape) == tuple(k.shape[:3]),
                 f"{name} must be fp32 {tuple(k.shape[:3])}, got "
                 f"{t.dtype} {tuple(t.shape)}")
            scales.append((name, t))
        need(dequant_dtype in (None,) + tuple(_DTYPE_CODE),
             f"dequant_dtype {dequant_dtype} (bf16 or fp32 only)")
    else:
        need(k.dtype == q.dtype and v.dtype == q.dtype,
             f"pool dtype {k.dtype}/{v.dtype} must equal q dtype "
             f"{q.dtype}")
    need(head_dim in HEAD_DIMS, f"head_dim {head_dim} not in {HEAD_DIMS}")
    need(k.shape == v.shape, "k and v pools differ in shape")
    kv_heads = k.shape[2]
    need(k.shape[3] == head_dim, "pool head_dim differs from q")
    need(kv_heads >= 1 and n_heads % kv_heads == 0,
         f"H={n_heads} not a multiple of KVH={kv_heads}")
    need(n_heads // kv_heads * s <= MAX_ROWS_PER_KV_HEAD,
         f"H/KVH*S={n_heads // kv_heads * s} query rows per KV head "
         f"exceed {MAX_ROWS_PER_KV_HEAD}")
    if block_table is None:
        need(k.shape[0] == batch, "slot pool batch differs from q")
        lane_len = k.shape[1]
    else:
        block_size = k.shape[1]
        need(block_size % 8 == 0, f"block size {block_size} not a "
             "multiple of 8")
        need(block_table.dtype == torch.int32 and block_table.dim() == 2
             and block_table.shape[0] == batch and
             block_table.device == q.device,
             "block_table must be int32 [B, max_blocks] on q's device")
        need(block_table.is_contiguous(), "block_table not contiguous")
        lane_len = block_table.shape[1] * block_size
    need(valid.dtype == torch.bool and
         tuple(valid.shape) == (batch, s, lane_len),
         f"valid must be bool [{batch}, {s}, {lane_len}], got "
         f"{valid.dtype} {tuple(valid.shape)}")
    operands = [("q", q), ("k", k), ("v", v), ("valid", valid)] + scales
    for name, t in operands:
        need(t.is_contiguous(), f"{name} not contiguous")
    need(q.is_cuda and all(t.device == q.device for _, t in operands),
         "all operands on one CUDA device")
    for name, t in (("k", k), ("v", v)):
        need(t.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")


def cuda_decode_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, valid: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          block_table: Optional[torch.Tensor] = None,
                          dequant_dtype=None) -> torch.Tensor:
    """Launch the kernel. Raises ``ValueError`` for an ineligible shape
    and ``KernelError`` when the kernel cannot build or launch."""
    from fengshen_tpu_torch.ops.kernels import build

    check_eligible(q, k, v, valid, block_table, k_scale, v_scale,
                   dequant_dtype)
    cap = torch.cuda.get_device_capability(q.device)
    if cap[0] != 9:
        raise KernelError(f"decode_attention kernel is built for sm_90a; "
                          f"{torch.cuda.get_device_name(q.device)} is "
                          f"sm_{cap[0]}{cap[1]}")
    lib = build.load()
    batch, s, n_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    out = torch.empty_like(q)
    if block_table is None:
        lane_len, block_size, max_blocks, num_blocks = k.shape[1], 0, 0, 0
        table_ptr = None
    else:
        block_size, max_blocks = k.shape[1], block_table.shape[1]
        lane_len, num_blocks = max_blocks * block_size, k.shape[0]
        table_ptr = block_table.data_ptr()
    # pool mode: 0 = the pool in q's dtype; int8 rounded through fp32 (1)
    # or through bf16 (2) after dequantization
    if k_scale is None:
        mode, ks_ptr, vs_ptr = 0, None, None
    else:
        mode = 2 if dequant_dtype == torch.bfloat16 else 1
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    pairs = batch * kv_heads
    splits, per = split_plan(lane_len, pairs, _sm_count(q.device))
    ws_ptr = cnt_ptr = None
    if splits > 1:
        rows = n_heads // kv_heads * s
        ws = torch.empty(pairs * splits * rows * (head_dim + 2),
                         dtype=torch.float32, device=q.device)
        ws_ptr, cnt_ptr = ws.data_ptr(), _counters(q.device, pairs).data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fstpu_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks_ptr, vs_ptr,
            valid.data_ptr(), table_ptr, out.data_ptr(), ws_ptr, cnt_ptr,
            batch, s, n_heads, kv_heads, head_dim, lane_len, block_size,
            max_blocks, num_blocks, splits, per, _DTYPE_CODE[q.dtype], mode,
            ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fstpu_error_string(rc).decode(errors="replace")
        raise KernelError(f"decode_attention kernel launch failed: "
                          f"CUDA error {rc} ({msg})")
    ENTRY.count(f"s{s}")
    return out


ENTRY = register_kernel(
    "decode_attention", kernel=cuda_decode_attention,
    plain=torch_decode_attention,
    source="fengshen_tpu_torch/csrc/decode_attention.cu",
    replaces="fengshen_tpu/ops/pallas/decode_attention.py:283")
