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
  launch.
- :func:`torch_decode_attention` is the plain version, a copy of
  ``xla_decode_attention`` (``:117-150``): take-gather of the paged
  pool, GQA repeat, then dense attention.

The kernel's rules are its own (the 128-multiples of the TPU kernel's
``pallas_decode_eligible`` were TPU tiling rules): head_dim 64 or 128,
any paged block size that is a multiple of 8, bf16 or fp32 pools in the
query's dtype, and at most 64 query rows per KV head (H/KVH * S).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fengshen_tpu_torch.ops.attention import dot_product_attention
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     block_table: Optional[torch.Tensor] = None,
                     dequant_dtype=None) -> torch.Tensor:
    """``q [B, S, H, D]``; ``k/v`` a slot pool ``[B, L, KVH, D]`` or, with
    ``block_table [B, max_blocks]`` int32, a paged pool
    ``[num_blocks, block_size, KVH, D]``; ``valid [B, S, L]`` bool over
    the (virtual) lane. Returns ``[B, S, H, D]`` in q's dtype."""
    del dequant_dtype
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV pools are not yet ported")
    if kernel_choice("decode_attention", q) == "cuda":
        if q.shape[1] <= MAX_QUERY_WINDOW:
            return cuda_decode_attention(q, k, v, valid,
                                         block_table=block_table)
        ENTRY.dense_calls += 1
    return torch_decode_attention(q, k, v, valid, block_table=block_table)


def torch_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor, *,
                           block_table: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version: ``xla_decode_attention`` op for op."""
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
    n_heads, kv_heads = q.shape[2], k.shape[2]
    if kv_heads != n_heads:
        rep = n_heads // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return dot_product_attention(q, k, v, mask=valid[:, None])


def check_eligible(q, k, v, valid, block_table=None) -> None:
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
    need(k.dtype == q.dtype and v.dtype == q.dtype,
         f"pool dtype {k.dtype}/{v.dtype} must equal q dtype {q.dtype}")
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
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        need(t.is_contiguous(), f"{name} not contiguous")
    need(q.is_cuda and all(t.device == q.device for t in (k, v, valid)),
         "all operands on one CUDA device")
    for name, t in (("k", k), ("v", v)):
        need(t.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")


def cuda_decode_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, valid: torch.Tensor, *,
                          block_table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch the kernel. Raises ``ValueError`` for an ineligible shape
    and ``KernelError`` when the kernel cannot build or launch."""
    from fengshen_tpu_torch.ops.kernels import build

    check_eligible(q, k, v, valid, block_table)
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fstpu_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            table_ptr, out.data_ptr(), batch, s, n_heads, kv_heads,
            head_dim, lane_len, block_size, max_blocks, num_blocks,
            _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fstpu_error_string(rc).decode(errors="replace")
        raise KernelError(f"decode_attention kernel launch failed: "
                          f"CUDA error {rc} ({msg})")
    ENTRY.launches += 1
    return out


ENTRY = register_kernel(
    "decode_attention", kernel=cuda_decode_attention,
    plain=torch_decode_attention,
    source="fengshen_tpu_torch/csrc/decode_attention.cu",
    replaces="fengshen_tpu/ops/pallas/decode_attention.py:283")
