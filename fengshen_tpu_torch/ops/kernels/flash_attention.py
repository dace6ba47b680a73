"""Flash attention: kernel K1, the port of
``fengshen_tpu/ops/pallas/flash_attention.py`` (forward and both
backward kernels).

- :class:`FlashAttention` is the seam, a ``torch.autograd.Function`` in
  the place of the reference's ``custom_vjp`` (``pallas_flash_attention``,
  :398). Its forward launches K1-fwd and saves ``out`` and ``lse``; its
  backward computes ``delta = rowsum(dO * O)`` as a torch op (the
  reference also computes it outside Pallas, :312-316), then launches
  K1-dkv and K1-dq. :func:`kernel_flash_attention` applies it; the
  dispatch in ``ops/flash_attention.py`` sends CUDA tensors here and CPU
  tensors to the plain version.
- :func:`cuda_flash_fwd`, :func:`cuda_flash_bwd_dkv` and
  :func:`cuda_flash_bwd_dq` are the kernels' wrappers: each checks
  device, dtype, shape and contiguity, allocates its outputs, launches on
  the current stream, raises ``KernelError`` on a non-zero launch code
  and counts the launch, by design (:data:`VARIANT`: bf16 inputs run the
  tensor-core kernels, fp32 the CUDA-core ones; one C entry point per
  kernel picks by dtype).
- :func:`torch_flash_forward` and :func:`torch_flash_backward` are the
  plain versions of the three kernels: ``plain_flash_attention`` (with
  its autograd for the gradients) and the log-sum-exp of its masked scores.

The kernels' rules are their own (the 128-multiples of the reference's
``_pallas_eligible`` were TPU tiling rules): head_dim 64 or 128, bf16 or
fp32 with q, k and v of one dtype, ``H % KVH == 0``, any sequence lengths,
no additive bias, segment ids int32 ``[B, Sq]`` / ``[B, Sk]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fengshen_tpu_torch.ops.flash_attention import plain_flash_attention
from fengshen_tpu_torch.ops.kernels import KernelError, register_kernel

HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' design per input dtype: bf16 on the tensor cores, fp32
#: as fp32 FMAs on the CUDA cores
VARIANT = {torch.float32: "fp32_fma", torch.bfloat16: "tensor_core"}
#: the masking constant of the plain version and the TPU kernels; a row
#: with no valid key has this log-sum-exp
NEG_INF = -1e30


def check_eligible(q, k, v, q_seg=None, kv_seg=None) -> None:
    """Raise ``ValueError`` for anything the kernels do not take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"flash attention kernel: {what}")

    need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
         "q/k/v must be 4-D [B, S, heads, head_dim]")
    batch, q_len, n_heads, head_dim = q.shape
    need(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (bf16 or fp32 only)")
    need(k.dtype == q.dtype and v.dtype == q.dtype,
         f"k/v dtype {k.dtype}/{v.dtype} must equal q dtype {q.dtype}")
    need(head_dim in HEAD_DIMS, f"head_dim {head_dim} not in {HEAD_DIMS}")
    need(k.shape == v.shape, "k and v differ in shape")
    need(k.shape[0] == batch and k.shape[3] == head_dim,
         "k/v batch or head_dim differ from q")
    kv_heads = k.shape[2]
    need(kv_heads >= 1 and n_heads % kv_heads == 0,
         f"H={n_heads} not a multiple of KVH={kv_heads}")
    need(q_len >= 1 and k.shape[1] >= 1, "empty sequence")
    need((q_seg is None) == (kv_seg is None),
         "give both segment-id arrays or neither")
    if q_seg is not None:
        need(q_seg.dtype == torch.int32 and kv_seg.dtype == torch.int32,
             "segment ids must be int32")
        need(tuple(q_seg.shape) == (batch, q_len) and
             tuple(kv_seg.shape) == (batch, k.shape[1]),
             f"segment ids must be [B, Sq] / [B, Sk], got "
             f"{tuple(q_seg.shape)} / {tuple(kv_seg.shape)}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if q_seg is not None:
        tensors += [("q_seg", q_seg), ("kv_seg", kv_seg)]
    for name, t in tensors:
        need(t.is_contiguous(), f"{name} not contiguous")
    need(q.is_cuda and all(t.device == q.device for _, t in tensors),
         "all operands on one CUDA device")
    for name, t in tensors[:3]:
        need(t.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")


def _library(device: torch.device):
    from fengshen_tpu_torch.ops.kernels import build
    cap = torch.cuda.get_device_capability(device)
    if cap[0] != 9:
        raise KernelError(f"flash attention kernels are built for sm_90a; "
                          f"{torch.cuda.get_device_name(device)} is "
                          f"sm_{cap[0]}{cap[1]}")
    return build.load()


def _seg_ptrs(q_seg, kv_seg):
    if q_seg is None:
        return None, None
    return q_seg.data_ptr(), kv_seg.data_ptr()


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fstpu_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what} kernel launch failed: CUDA error {rc} "
                          f"({msg})")


def _dims(q, k):
    batch, q_len, n_heads, head_dim = q.shape
    return batch, q_len, k.shape[1], n_heads, k.shape[2], head_dim


def cuda_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_seg: Optional[torch.Tensor] = None,
                   kv_seg: Optional[torch.Tensor] = None,
                   causal: bool = False):
    """Launch K1-fwd. Returns ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``."""
    check_eligible(q, k, v, q_seg, kv_seg)
    lib = _library(q.device)
    batch, q_len, k_len, n_heads, kv_heads, head_dim = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty(batch, n_heads, q_len, dtype=torch.float32,
                      device=q.device)
    sq, sk = _seg_ptrs(q_seg, kv_seg)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fstpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sq, sk,
            out.data_ptr(), lse.data_ptr(), batch, q_len, k_len, n_heads,
            kv_heads, head_dim, int(causal), _DTYPE_CODE[q.dtype],
            ctypes.c_void_p(stream))
    _check_rc(lib, rc, "flash attention forward")
    FWD.count(VARIANT[q.dtype])
    return out, lse


def _check_bwd(q, out, dout, lse, delta) -> None:
    batch, q_len, n_heads, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash attention kernel: {name} must match q "
                             "in shape, dtype and device, contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (batch, n_heads, q_len) or \
                t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != q.device:
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"fp32 [{batch}, {n_heads}, {q_len}], "
                             "contiguous, on q's device")


def cuda_flash_bwd_dkv(q, k, v, out, dout, lse, delta, q_seg=None,
                       kv_seg=None, causal: bool = False):
    """Launch K1-dkv. Returns ``(dk, dv)`` at the KV head count (summed
    over each GQA group inside the kernel)."""
    check_eligible(q, k, v, q_seg, kv_seg)
    _check_bwd(q, out, dout, lse, delta)
    lib = _library(q.device)
    batch, q_len, k_len, n_heads, kv_heads, head_dim = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sq, sk = _seg_ptrs(q_seg, kv_seg)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fstpu_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), sq, sk, dk.data_ptr(),
            dv.data_ptr(), batch, q_len, k_len, n_heads, kv_heads, head_dim,
            int(causal), _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _check_rc(lib, rc, "flash attention dK/dV")
    DKV.count(VARIANT[q.dtype])
    return dk, dv


def cuda_flash_bwd_dq(q, k, v, out, dout, lse, delta, q_seg=None,
                      kv_seg=None, causal: bool = False):
    """Launch K1-dq. Returns ``dq``."""
    check_eligible(q, k, v, q_seg, kv_seg)
    _check_bwd(q, out, dout, lse, delta)
    lib = _library(q.device)
    batch, q_len, k_len, n_heads, kv_heads, head_dim = _dims(q, k)
    dq = torch.empty_like(q)
    sq, sk = _seg_ptrs(q_seg, kv_seg)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fstpu_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), sq, sk, dq.data_ptr(), batch,
            q_len, k_len, n_heads, kv_heads, head_dim, int(causal),
            _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _check_rc(lib, rc, "flash attention dQ")
    DQ.count(VARIANT[q.dtype])
    return dq


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, as ``[B, H, Sq]``."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """K1 with its two backward kernels (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        out, lse = cuda_flash_fwd(q, k, v, q_seg, kv_seg, causal)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dk, dv = cuda_flash_bwd_dkv(q, k, v, out, dout, lse, delta, q_seg,
                                    kv_seg, ctx.causal)
        dq = cuda_flash_bwd_dq(q, k, v, out, dout, lse, delta, q_seg,
                               kv_seg, ctx.causal)
        return dq, dk, dv, None, None, None


def kernel_flash_attention(q, k, v, q_seg=None, kv_seg=None,
                           causal: bool = False) -> torch.Tensor:
    """K1 on CUDA tensors, differentiable. Raises ``ValueError`` for a
    shape outside the kernels' rules and ``KernelError`` when a kernel
    cannot build or launch."""
    return FlashAttention.apply(q, k, v, q_seg, kv_seg, causal)


# -- plain versions -------------------------------------------------------

def _masked_scores(q, k, q_seg, kv_seg, causal):
    """fp32 ``scale * Q K^T`` as ``[B, H, Sq, Sk]`` (query head ``h``
    reads KV head ``h // (H / KVH)``, as the repeat orders them), and the
    pairs a query may attend to, broadcastable to it."""
    batch, q_len, n_heads, head_dim = q.shape
    k_len, kv_heads = k.shape[1], k.shape[2]
    scale = (1.0 / torch.sqrt(torch.tensor(float(head_dim)))).item()
    qg = q.float().reshape(batch, q_len, kv_heads, n_heads // kv_heads,
                           head_dim)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()).reshape(
        batch, n_heads, q_len, k_len) * scale
    allowed = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(k_len - q_len, k_len, device=q.device)
        allowed = torch.arange(k_len, device=q.device)[None] <= q_pos[:, None]
    allowed = allowed[None, None]
    if q_seg is not None:
        allowed = allowed & (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
    return scores, allowed


def torch_flash_forward(q, k, v, q_seg=None, kv_seg=None,
                        causal: bool = False):
    """Plain K1-fwd: ``plain_flash_attention`` for ``out``, and the
    log-sum-exp of the same masked fp32 scores for ``lse [B, H, Sq]``
    (-1e30 for a row with no valid key, as the kernels write it)."""
    out = plain_flash_attention(q, k, v, causal=causal, q_segment_ids=q_seg,
                                kv_segment_ids=kv_seg)
    scores, allowed = _masked_scores(q, k, q_seg, kv_seg, causal)
    lse = torch.logsumexp(scores.masked_fill(~allowed, NEG_INF), dim=-1)
    return out, lse


def torch_flash_backward(q, k, v, dout, q_seg=None, kv_seg=None,
                         causal: bool = False):
    """The attention's gradients ``(dq, dk, dv)`` by autograd through
    ``plain_flash_attention`` (dk/dv summed over each GQA group by the
    repeat's own gradient), with delta from its own unrounded out."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = plain_flash_attention(qg, kg, vg, causal=causal,
                                    q_segment_ids=q_seg,
                                    kv_segment_ids=kv_seg)
        return torch.autograd.grad(out, (qg, kg, vg), dout)


def torch_flash_bwd(q, k, v, dout, lse, delta, q_seg=None, kv_seg=None,
                    causal: bool = False):
    """Plain K1-dkv and K1-dq on the kernels' own inputs, in fp32:
    ``P = exp(scale Q K^T - lse)`` on the valid pairs, ``dS = P (dO V^T
    - delta)``, ``dq = scale dS K``, ``dk = scale dS^T Q`` and ``dv = P^T
    dO``, dk/dv summed over each GQA group. A row with no valid key
    (lse -1e30) gives ``dv += dO / Sk`` to every key and nothing else.
    Returns ``(dq, dk, dv)`` in q's dtype."""
    batch, q_len, n_heads, head_dim = q.shape
    k_len, kv_heads = k.shape[1], k.shape[2]
    group = (batch, kv_heads, n_heads // kv_heads, q_len, k_len)
    scale = (1.0 / torch.sqrt(torch.tensor(float(head_dim)))).item()
    scores, allowed = _masked_scores(q, k, q_seg, kv_seg, causal)
    lse = lse.float()[..., None]
    dead = lse <= 0.5 * NEG_INF
    probs = torch.where(allowed, torch.exp(scores - lse), 0.0)
    probs = torch.where(dead, 1.0 / k_len, probs).reshape(group)
    del scores
    dog = dout.float().reshape(batch, q_len, kv_heads, -1, head_dim)
    qg = q.float().reshape(dog.shape)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    valid = (allowed & ~dead).reshape(group)
    ds = (probs * (dp - delta.float().reshape(group[:4])[..., None])
          ).masked_fill(~valid, 0.0)
    del dp
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    dv = torch.einsum("bgrqk,bqgrd->bkgd", probs, dog)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _plain_dkv(q, k, v, out, dout, lse, delta, q_seg=None, kv_seg=None,
               causal: bool = False):
    del out
    return torch_flash_bwd(q, k, v, dout, lse, delta, q_seg, kv_seg,
                           causal)[1:]


def _plain_dq(q, k, v, out, dout, lse, delta, q_seg=None, kv_seg=None,
              causal: bool = False):
    del out
    return torch_flash_bwd(q, k, v, dout, lse, delta, q_seg, kv_seg,
                           causal)[0]


_SOURCE = "fengshen_tpu_torch/csrc/flash_attention.cu"
FWD = register_kernel(
    "flash_attention_fwd", kernel=cuda_flash_fwd, plain=torch_flash_forward,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/flash_attention.py:139")
DKV = register_kernel(
    "flash_attention_bwd_dkv", kernel=cuda_flash_bwd_dkv, plain=_plain_dkv,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/flash_attention.py:329")
DQ = register_kernel(
    "flash_attention_bwd_dq", kernel=cuda_flash_bwd_dq, plain=_plain_dq,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/flash_attention.py:370")
