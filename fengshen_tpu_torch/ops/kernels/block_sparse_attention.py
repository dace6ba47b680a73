"""Block-sparse attention: kernel K4, the port of
``fengshen_tpu/ops/pallas/block_sparse_attention.py`` (forward and both
backward kernels).

Attention over the present blocks of a static ``[nQ, nK]`` block
layout (numpy bool; ``ops/masks.py`` builds BigBird, Longformer and
fixed layouts); absent blocks are skipped, so the work scales with the
present blocks, not with ``Sq x Sk``. A query block with no present key
block gives zeros (and an lse of about -1e30), as the TPU kernel does;
the dense fallback of ``ops/attention.dot_product_attention`` gives such
a row the uniform mean of V instead (a property of the reference).

- :class:`BlockSparseAttention` is the counterpart of the reference's
  ``custom_vjp`` (``_block_sparse_vjp``, :199-295): its forward runs
  K4-fwd and saves ``q, k, v, out, lse`` and the layout; its backward
  forms ``delta = sum(dO * out)`` in fp32 from the stored ``out`` (in
  q's dtype, as the reference's) and runs K4-dkv and K4-dq. The layout
  has no gradient. On CUDA tensors it launches the kernels, on CPU
  tensors their plain versions. :func:`block_sparse_attention` applies
  it.
- :func:`cuda_bs_fwd`, :func:`cuda_bs_bwd_dkv` and :func:`cuda_bs_bwd_dq`
  are the kernels' wrappers: each checks its operands, allocates its
  outputs, launches on the current stream, raises ``KernelError`` on a
  non-zero launch code and counts the launch, by design (:data:`VARIANT`:
  bf16 inputs run the tensor-core kernels, fp32 the CUDA-core ones; one
  C entry point per kernel picks by dtype). The layout goes to the
  kernels as compact lists of present blocks per query-block row (CSR)
  and per key-block column (its transpose), built once on the host by
  :func:`block_csr`, so no kernel loops over an absent block, with the
  rows and the columns in :func:`heavy_first` order, so the tiles with
  the most present blocks start first.
- :func:`torch_bs_fwd` and :func:`torch_bs_bwd` are the plain versions:
  per query block, over its present key blocks, each computes what the
  TPU kernels compute, with their rounding: the forward scales ``q`` in
  fp32 before the product, the backward scales the product after it,
  lse is ``max + log(max(sum, 1e-30))``, and dq/dk/dv are cast to the
  dtypes of q/k/v. :func:`torch_block_sparse_attention` is the plain
  forward's output alone.

The kernels' rules are their own (the 128-multiples of the reference's
eligibility were TPU tiling rules): q, k and v ``[B, S, H, D]`` of one
dtype, bf16 or fp32, with the same B, H and D; head_dim 64 or 128; a
block size that is a multiple of 64 (the kernels' tile: 128, the
reference's default, is two tiles); ``Sq`` and ``Sk`` multiples of the
block; ``layout.shape == (Sq / block, Sk / block)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fengshen_tpu_torch.ops.kernels import (KernelError, kernel_choice,
                                            register_kernel)

HEAD_DIMS = (64, 128)
#: the kernels' tile: a block size must be a multiple of it
TILE = 64
#: tiles along a sequence: the launch grid's second dimension
MAX_TILES = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' design per input dtype: bf16 on the tensor cores, fp32
#: as fp32 FMAs on the CUDA cores
VARIANT = {torch.float32: "fp32_fma", torch.bfloat16: "tensor_core"}
#: the TPU kernels' masking constant: the running max of an empty row
NEG_INF = -1e30


class BlockCSR(NamedTuple):
    """A layout's present blocks as int32 device tensors: per query-block
    row (``row_ptr [nQ + 1]``, ``col_idx [nnz]``) and per key-block
    column (``col_ptr [nK + 1]``, ``row_idx [nnz]``), each list in
    ascending order, and the rows and the columns in :func:`heavy_first`
    order (``row_order [nQ]``, ``col_order [nK]``)."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    col_ptr: torch.Tensor
    row_idx: torch.Tensor
    row_order: torch.Tensor
    col_order: torch.Tensor


def heavy_first(layout) -> np.ndarray:
    """The rows of a ``[n, m]`` block layout ordered by their present
    blocks, most first (ties in row order), as int32: the order in which
    the kernels' grid walks query blocks (pass ``layout.T`` for key
    blocks), so the longest tiles start first."""
    counts = np.asarray(layout, dtype=bool).sum(1)
    return np.argsort(-counts, kind="stable").astype(np.int32)


def block_csr(layout, device) -> BlockCSR:
    """The CSR and CSC lists of a numpy ``[nQ, nK]`` block layout, and
    its rows' and columns' heavy-first orders."""
    lay = np.asarray(layout, dtype=bool)

    def lists(m):
        ptr = np.concatenate([[0], np.cumsum(m.sum(1))]).astype(np.int32)
        idx = np.nonzero(m)[1].astype(np.int32)
        return (torch.from_numpy(ptr).to(device),
                torch.from_numpy(idx).to(device))

    orders = (torch.from_numpy(heavy_first(m)).to(device)
              for m in (lay, lay.T))
    return BlockCSR(*lists(lay), *lists(lay.T), *orders)


def check_eligible(q, k, v, layout, block_size: int) -> None:
    """Raise ``ValueError`` for anything the kernels do not take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"block-sparse attention kernel: {what}")

    need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
         "q/k/v must be 4-D [B, S, heads, head_dim]")
    batch, q_len, n_heads, head_dim = q.shape
    need(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (bf16 or fp32 only)")
    need(k.dtype == q.dtype and v.dtype == q.dtype,
         f"k/v dtype {k.dtype}/{v.dtype} must equal q dtype {q.dtype}")
    need(head_dim in HEAD_DIMS, f"head_dim {head_dim} not in {HEAD_DIMS}")
    need(k.shape == v.shape and k.shape[0] == batch and
         k.shape[2] == n_heads and k.shape[3] == head_dim,
         "k/v must be [B, Sk, H, D] with q's B, H and D")
    need(block_size >= TILE and block_size % TILE == 0,
         f"block size {block_size} not a multiple of {TILE}")
    need(q_len % block_size == 0 and k.shape[1] % block_size == 0,
         f"Sq={q_len} and Sk={k.shape[1]} must be multiples of the block "
         f"{block_size}")
    shape = (q_len // block_size, k.shape[1] // block_size)
    need(np.shape(layout) == shape,
         f"layout {np.shape(layout)} != block grid {shape}")
    need(max(q_len, k.shape[1]) // TILE <= MAX_TILES,
         f"sequences longer than {MAX_TILES * TILE} tokens")
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(t.is_contiguous(), f"{name} not contiguous")
    need(q.is_cuda and k.device == q.device and v.device == q.device,
         "all operands on one CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(t.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")


def _library(device: torch.device):
    from fengshen_tpu_torch.ops.kernels import build
    cap = torch.cuda.get_device_capability(device)
    if cap[0] != 9:
        raise KernelError(f"block-sparse attention kernels are built for "
                          f"sm_90a; {torch.cuda.get_device_name(device)} "
                          f"is sm_{cap[0]}{cap[1]}")
    return build.load()


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fstpu_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what} kernel launch failed: CUDA error {rc} "
                          f"({msg})")


def _check_bwd(q, dout, lse, delta) -> None:
    batch, q_len, n_heads, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            not dout.is_contiguous() or dout.device != q.device or \
            dout.data_ptr() % 16:
        raise ValueError("block-sparse attention kernel: dout must match q "
                         "in shape, dtype and device, contiguous and "
                         "16-byte aligned")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (batch, n_heads, q_len) or \
                t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != q.device:
            raise ValueError(f"block-sparse attention kernel: {name} must "
                             f"be fp32 [{batch}, {n_heads}, {q_len}], "
                             "contiguous, on q's device")


def _launch(fn, what: str, q, k, csr_lists, tensors, block_size: int):
    lib = _library(q.device)
    batch, q_len, n_heads, head_dim = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(
            *(None if t is None else t.data_ptr() for t in tensors),
            *(t.data_ptr() for t in csr_lists), batch, q_len, k.shape[1],
            n_heads, head_dim, block_size, _DTYPE_CODE[q.dtype],
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, what)


def cuda_bs_fwd(q, k, v, layout, block_size: int, csr: BlockCSR = None):
    """Launch K4-fwd. Returns ``(out [B, Sq, H, D], lse [B, H, Sq]
    fp32)``."""
    check_eligible(q, k, v, layout, block_size)
    csr = block_csr(layout, q.device) if csr is None else csr
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    _launch("fstpu_bs_fwd", "block-sparse attention forward", q, k,
            (csr.row_ptr, csr.col_idx, csr.row_order),
            (q, k, v, None, None, None, out, None, lse), block_size)
    FWD.count(VARIANT[q.dtype])
    return out, lse


def cuda_bs_bwd_dkv(q, k, v, dout, lse, delta, layout, block_size: int,
                    csr: BlockCSR = None):
    """Launch K4-dkv. Returns ``(dk, dv)``; a key block that no query
    block reaches gets zeros."""
    check_eligible(q, k, v, layout, block_size)
    _check_bwd(q, dout, lse, delta)
    csr = block_csr(layout, q.device) if csr is None else csr
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("fstpu_bs_bwd_dkv", "block-sparse attention dK/dV", q, k,
            (csr.col_ptr, csr.row_idx, csr.col_order),
            (q, k, v, dout, lse, delta, dk, dv, None), block_size)
    DKV.count(VARIANT[q.dtype])
    return dk, dv


def cuda_bs_bwd_dq(q, k, v, dout, lse, delta, layout, block_size: int,
                   csr: BlockCSR = None):
    """Launch K4-dq. Returns ``dq``."""
    check_eligible(q, k, v, layout, block_size)
    _check_bwd(q, dout, lse, delta)
    csr = block_csr(layout, q.device) if csr is None else csr
    dq = torch.empty_like(q)
    _launch("fstpu_bs_bwd_dq", "block-sparse attention dQ", q, k,
            (csr.row_ptr, csr.col_idx, csr.row_order),
            (q, k, v, dout, lse, delta, dq, None, None), block_size)
    DQ.count(VARIANT[q.dtype])
    return dq


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = sum(dO * out)`` over head_dim in fp32, ``[B, H, Sq]``."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class BlockSparseAttention(torch.autograd.Function):
    """K4 with its two backward kernels (the reference's custom VJP);
    CPU tensors take the kernels' plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block_size):
        cuda = kernel_choice("block_sparse_attention_fwd", q) == "cuda"
        csr = block_csr(layout, q.device) if cuda else None
        if cuda:
            out, lse = cuda_bs_fwd(q, k, v, layout, block_size, csr)
        else:
            out, lse = torch_bs_fwd(q, k, v, layout, block_size)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout, ctx.block_size, ctx.csr = layout, block_size, csr
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, ctx.layout, ctx.block_size)
        if ctx.csr is not None:
            dk, dv = cuda_bs_bwd_dkv(*args, csr=ctx.csr)
            dq = cuda_bs_bwd_dq(*args, csr=ctx.csr)
        else:
            dq, dk, dv = torch_bs_bwd(*args)
        return dq, dk, dv, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layout, block_size: int
                           ) -> torch.Tensor:
    """``q/k/v [B, S, H, D]``, ``layout`` a numpy bool ``[Sq / block,
    Sk / block]``. Differentiable in q, k and v. On CUDA tensors K4 runs
    (a shape outside its rules raises ``ValueError``, a build or launch
    failure ``KernelError``); CPU tensors take the plain versions."""
    return BlockSparseAttention.apply(q, k, v,
                                      np.asarray(layout, dtype=bool),
                                      block_size)


# -- plain versions -------------------------------------------------------

def _blocks(layout, block_size: int, device):
    """Per query block: its row range and the key positions of its
    present key blocks (ascending)."""
    span = torch.arange(block_size, device=device)
    for i, row in enumerate(np.asarray(layout, dtype=bool)):
        cols = torch.from_numpy(np.nonzero(row)[0]).to(device)
        keys = (cols[:, None] * block_size + span).reshape(-1)
        yield slice(i * block_size, (i + 1) * block_size), keys


def _scale(head_dim: int) -> float:
    # the reference's float(1 / sqrt(D)), applied to fp32 operands
    return float(1.0 / (head_dim ** 0.5))


def torch_bs_fwd(q, k, v, layout, block_size: int):
    """Plain K4-fwd: ``(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    fp32)``. Per query block, ``s = (q scale) K^T`` over the present key
    blocks, ``m = max(-1e30, max s)``, ``l = sum exp(s - m)``,
    ``out = exp(s - m) V / max(l, 1e-30)`` and ``lse = m + log(max(l,
    1e-30))``: an empty row gives zeros and lse ~ -1e30."""
    batch, q_len, n_heads, head_dim = q.shape
    qs = q.float() * _scale(head_dim)
    out = torch.zeros(batch, q_len, n_heads, head_dim, dtype=torch.float32,
                      device=q.device)
    lse = torch.empty(batch, n_heads, q_len, dtype=torch.float32,
                      device=q.device)
    for rows, keys in _blocks(layout, block_size, q.device):
        s = torch.einsum("bqhd,bkhd->bhqk", qs[:, rows], k[:, keys].float())
        m = torch.clamp(s.amax(-1) if keys.numel() else
                        torch.full(s.shape[:-1], NEG_INF, device=q.device),
                        min=NEG_INF)
        p = torch.exp(s - m[..., None])
        denom = torch.clamp(p.sum(-1), min=1e-30)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v[:, keys].float())
        out[:, rows] = pv / denom.transpose(1, 2)[..., None]
        lse[:, :, rows] = m + torch.log(denom)
    return out.to(q.dtype), lse


def torch_block_sparse_attention(q, k, v, layout, block_size: int):
    """The plain K4 forward's output ``[B, Sq, H, D]``."""
    return torch_bs_fwd(q, k, v, layout, block_size)[0]


def torch_bs_bwd(q, k, v, dout, lse, delta, layout, block_size: int):
    """Plain K4-dkv and K4-dq on the kernels' own inputs, in fp32: per
    present block ``p = exp((q K^T) scale - lse)``, ``ds = p (dO V^T -
    delta) scale``, ``dq += ds K``, ``dk += ds^T q``, ``dv += p^T dO``.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    scale = _scale(q.shape[-1])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for rows, keys in _blocks(layout, block_size, q.device):
        if not keys.numel():
            continue
        kk, vv = kf[:, keys], vf[:, keys]
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kk) * scale
        p = torch.exp(s - lse[:, :, rows, None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows], vv)
        ds = p * (dp - delta[:, :, rows, None]) * scale
        dq[:, rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kk)
        dk.index_add_(1, keys, torch.einsum("bhqk,bqhd->bkhd", ds,
                                            qf[:, rows]))
        dv.index_add_(1, keys, torch.einsum("bhqk,bqhd->bkhd", p,
                                            dof[:, rows]))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _plain_dkv(q, k, v, dout, lse, delta, layout, block_size, csr=None):
    del csr
    return torch_bs_bwd(q, k, v, dout, lse, delta, layout, block_size)[1:]


def _plain_dq(q, k, v, dout, lse, delta, layout, block_size, csr=None):
    del csr
    return torch_bs_bwd(q, k, v, dout, lse, delta, layout, block_size)[0]


def _plain_fwd(q, k, v, layout, block_size, csr=None):
    del csr
    return torch_bs_fwd(q, k, v, layout, block_size)


_SOURCE = "fengshen_tpu_torch/csrc/block_sparse_attention.cu"
_REF = "fengshen_tpu/ops/pallas/block_sparse_attention.py"
FWD = register_kernel(
    "block_sparse_attention_fwd", kernel=cuda_bs_fwd, plain=_plain_fwd,
    source=_SOURCE, replaces=f"{_REF}:187")
DKV = register_kernel(
    "block_sparse_attention_bwd_dkv", kernel=cuda_bs_bwd_dkv,
    plain=_plain_dkv, source=_SOURCE, replaces=f"{_REF}:253")
DQ = register_kernel(
    "block_sparse_attention_bwd_dq", kernel=cuda_bs_bwd_dq, plain=_plain_dq,
    source=_SOURCE, replaces=f"{_REF}:285")
