"""Fused LM-head cross-entropy: kernel K2, the port of
``fengshen_tpu/ops/pallas/fused_ce.py`` (forward and both backward
kernels).

- :func:`fused_ce_loss` is the seam (:37): a CUDA tensor goes to the
  kernels through :func:`kernel_fused_ce`, a CPU tensor to the plain
  version, ``ops/fused_ce.py fused_lm_head_ce`` (the reference's
  ``xla_fused_ce``, :66, is that same function). A shape outside the
  kernels' rules raises; nothing falls back.
- :func:`kernel_fused_ce` keeps the ``pallas_fused_ce`` contract (:320):
  the ``T = B * S`` tokens are flattened, ``num_chunks`` is accepted and
  ignored, the loss is ``sum(valid * (lse - gold)) / max(n_valid, 1)``
  and ``n_correct`` counts ``(amax == label) & valid``. The reference
  pads the tokens with ``ignore_index`` to its tile; the kernels mask
  their ragged edge themselves, so nothing is padded here.
- :class:`TokenStats` is the counterpart of ``_token_stats`` (:241-317):
  its forward launches K2-fwd and saves x, the head, the labels and
  ``lse``; its backward walks the tokens in chunks of
  :data:`BWD_CHUNK`, and for each launches K2-dx (which recomputes the
  chunk's ``d = c_lse * softmax + c_gold * onehot`` once, in fp32, into
  a workspace in x's dtype, and forms ``dx = d K^T``) and K2-dK (``dK
  += x^T d`` in an fp32 sum; the last chunk writes it in K's dtype).
  In bf16 the workspace feeds the tensor cores and holds only d's
  softmax part; the kernels add the one-hot part in fp32 from the labels
  and ``c_gold``. In fp32 it holds all of d. ``amax`` has no gradient.
  So a training step launches K2-fwd once, K2-dx and K2-dK
  ``ceil(T / BWD_CHUNK)`` times each.
- :func:`cuda_ce_fwd`, :func:`cuda_ce_bwd_dx` and :func:`cuda_ce_bwd_dk`
  wrap the kernels: each checks its operands, launches on the current
  stream, raises ``KernelError`` on a non-zero launch code and counts
  the launch, by design (:data:`VARIANT`: bf16 inputs run the
  tensor-core kernels, fp32 the CUDA-core ones; one C entry point per
  kernel picks by dtype).
- :func:`torch_ce_token_stats`, :func:`torch_ce_bwd_dx` and
  :func:`torch_ce_bwd_dk` are the three kernels' plain versions, chunked
  over the tokens so the full logits never exist at once either.

The kernels' rules: x ``[T, H]`` and the head ``[H, V]`` of one dtype,
bf16 or fp32, contiguous; labels int32 ``[T]``; any T, H, V >= 1.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fengshen_tpu_torch.ops.fused_ce import fused_lm_head_ce
from fengshen_tpu_torch.ops.kernels import (KernelError, kernel_choice,
                                            register_kernel)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' design per input dtype: bf16 on the tensor cores, fp32
#: as fp32 FMAs on the CUDA cores
VARIANT = {torch.float32: "fp32_fma", torch.bfloat16: "tensor_core"}
#: tokens per backward chunk: the workspace d is [BWD_CHUNK, V] in x's
#: dtype (62.5 MiB in bf16 at V = 32000)
BWD_CHUNK = 1024
#: tokens per chunk of the plain versions
PLAIN_CHUNK = 4096


def check_eligible(x, w, labels) -> None:
    """Raise ``ValueError`` for anything the kernels do not take."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"fused CE kernel: {what}")

    need(x.dim() == 2 and w.dim() == 2, "x must be [T, H], the head [H, V]")
    need(x.shape[1] == w.shape[0],
         f"x is [T, {x.shape[1]}] but the head is {list(w.shape)}")
    need(x.shape[0] >= 1 and w.shape[0] >= 1 and w.shape[1] >= 1,
         "empty operand")
    need(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (bf16 or fp32 only)")
    need(w.dtype == x.dtype, f"head dtype {w.dtype} != x dtype {x.dtype}")
    need(labels.dtype == torch.int32 and tuple(labels.shape) ==
         (x.shape[0],), "labels must be int32 [T]")
    for name, t in (("x", x), ("head", w), ("labels", labels)):
        need(t.is_contiguous(), f"{name} not contiguous")
        need(t.is_cuda and t.device == x.device,
             "all operands on one CUDA device")


def _library(device: torch.device):
    from fengshen_tpu_torch.ops.kernels import build
    cap = torch.cuda.get_device_capability(device)
    if cap[0] != 9:
        raise KernelError(f"fused CE kernels are built for sm_90a; "
                          f"{torch.cuda.get_device_name(device)} is "
                          f"sm_{cap[0]}{cap[1]}")
    return build.load()


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fstpu_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what} kernel launch failed: CUDA error {rc} "
                          f"({msg})")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _rows(name, t, n, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) or \
            not t.is_contiguous() or t.device != device:
        raise ValueError(f"fused CE kernel: {name} must be fp32 [{n}], "
                         "contiguous, on x's device")


def cuda_ce_fwd(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Launch K2-fwd. Returns ``(lse, gold, amax)``: fp32, fp32 and int32
    ``[T]``."""
    check_eligible(x, w, labels)
    lib = _library(x.device)
    n_tok, hid = x.shape
    lse = torch.empty(n_tok, dtype=torch.float32, device=x.device)
    gold = torch.empty_like(lse)
    amax = torch.empty(n_tok, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.fstpu_ce_fwd(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                              lse.data_ptr(), gold.data_ptr(),
                              amax.data_ptr(), n_tok, hid, w.shape[1],
                              _DTYPE_CODE[x.dtype], _stream(x))
    _check_rc(lib, rc, "fused CE forward")
    FWD.count(VARIANT[x.dtype])
    return lse, gold, amax


def cuda_ce_bwd_dx(x, w, labels, lse, c_lse, c_gold, d, dx=None):
    """Launch K2-dx on one chunk of tokens: the chunk's ``d`` into the
    workspace ``d`` (x's dtype, at least ``[T_chunk, V]``; the first rows
    are written), then ``dx = d K^T`` into ``dx`` (allocated when None).
    Returns ``dx``."""
    check_eligible(x, w, labels)
    n_tok, hid = x.shape
    vocab = w.shape[1]
    for name, t in (("lse", lse), ("c_lse", c_lse), ("c_gold", c_gold)):
        _rows(name, t, n_tok, x.device)
    if d.dtype != x.dtype or d.dim() != 2 or d.shape[0] < n_tok or \
            d.shape[1] != vocab or not d.is_contiguous() or \
            d.device != x.device:
        raise ValueError(f"fused CE kernel: the workspace must be "
                         f"{x.dtype} [>= {n_tok}, {vocab}], contiguous, on "
                         "x's device")
    if dx is None:
        dx = torch.empty_like(x)
    elif dx.shape != x.shape or dx.dtype != x.dtype or \
            not dx.is_contiguous() or dx.device != x.device:
        raise ValueError("fused CE kernel: dx must match x")
    lib = _library(x.device)
    with torch.cuda.device(x.device):
        rc = lib.fstpu_ce_bwd_dx(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            c_lse.data_ptr(), c_gold.data_ptr(), d.data_ptr(), dx.data_ptr(),
            n_tok, hid, vocab, _DTYPE_CODE[x.dtype], _stream(x))
    _check_rc(lib, rc, "fused CE dx")
    DX.count(VARIANT[x.dtype])
    return dx


def cuda_ce_bwd_dk(x, d, labels, c_gold, total, dk=None,
                   first: bool = True):
    """Launch K2-dK on one chunk of tokens: add ``x^T d`` to the fp32
    sum ``total [H, V]`` (which starts here when ``first``); with ``dk``
    given, write the finished sum there in its dtype instead (the last
    chunk; ``total`` may then be None if this is also the first).
    ``d`` is the chunk's workspace from K2-dx; ``labels`` (int32) and
    ``c_gold`` (fp32) are the chunk's ``[T_chunk]``: the bf16 kernels
    add d's one-hot part from them, as their workspace holds only its
    softmax part. Returns ``dk`` or ``total``."""
    n_tok, hid = x.shape
    vocab = d.shape[1]
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous() or \
            not x.is_cuda:
        raise ValueError("fused CE kernel: x must be contiguous bf16/fp32 "
                         "on a CUDA device")
    if total is None and not (first and dk is not None):
        raise ValueError("fused CE kernel: the fp32 sum is needed unless "
                         "one chunk writes dK directly")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (n_tok,) or \
            not labels.is_contiguous() or labels.device != x.device:
        raise ValueError(f"fused CE kernel: labels must be int32 "
                         f"[{n_tok}], contiguous, on x's device")
    _rows("c_gold", c_gold, n_tok, x.device)
    for name, t, shape, dtype in (("d", d, None, x.dtype),
                                  ("total", total, (hid, vocab),
                                   torch.float32),
                                  ("dk", dk, (hid, vocab), x.dtype)):
        if t is None:
            continue
        ok = t.dtype == dtype and t.is_contiguous() and t.device == x.device
        ok = ok and (tuple(t.shape) == shape if shape else
                     t.dim() == 2 and t.shape[0] >= n_tok and
                     t.shape[1] == vocab)
        if not ok:
            raise ValueError(f"fused CE kernel: {name} must be {dtype}, "
                             f"{shape or f'[>= {n_tok}, {vocab}]'}, "
                             "contiguous, on x's device")
    lib = _library(x.device)
    with torch.cuda.device(x.device):
        rc = lib.fstpu_ce_bwd_dk(
            x.data_ptr(), d.data_ptr(), labels.data_ptr(),
            c_gold.data_ptr(),
            None if total is None else total.data_ptr(),
            None if dk is None else dk.data_ptr(), int(first), n_tok, hid,
            vocab, _DTYPE_CODE[x.dtype], _stream(x))
    _check_rc(lib, rc, "fused CE dK")
    DK.count(VARIANT[x.dtype])
    return total if dk is None else dk


def kernel_ce_backward(x, w, labels, lse, c_lse, c_gold,
                       chunk: Optional[int] = None):
    """``(dx, dK)`` through the kernels, ``chunk`` tokens at a time
    (default :data:`BWD_CHUNK`)."""
    chunk = chunk or BWD_CHUNK
    n_tok = x.shape[0]
    c_lse = c_lse.float().contiguous()
    c_gold = c_gold.float().contiguous()
    dx = torch.empty_like(x)
    dk = torch.empty_like(w)
    d = torch.empty(min(chunk, n_tok), w.shape[1], dtype=x.dtype,
                    device=x.device)
    starts = range(0, n_tok, chunk)
    # the fp32 sum across chunks; one chunk writes dK directly
    total = None if len(starts) == 1 else torch.empty(
        w.shape, dtype=torch.float32, device=x.device)
    for i, t0 in enumerate(starts):
        sl = slice(t0, min(t0 + chunk, n_tok))
        cuda_ce_bwd_dx(x[sl], w, labels[sl], lse[sl], c_lse[sl], c_gold[sl],
                       d, dx[sl])
        last = t0 + chunk >= n_tok
        cuda_ce_bwd_dk(x[sl], d, labels[sl], c_gold[sl], total,
                       dk if last else None, first=i == 0)
    return dx, dk


class TokenStats(torch.autograd.Function):
    """K2 with its two backward kernels (the reference's ``custom_vjp``
    around ``_token_stats``)."""

    @staticmethod
    def forward(ctx, x, w, labels):
        lse, gold, amax = cuda_ce_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.mark_non_differentiable(amax)
        return lse, gold, amax

    @staticmethod
    def backward(ctx, c_lse, c_gold, _):
        x, w, labels, lse = ctx.saved_tensors
        if c_lse is None:
            c_lse = torch.zeros_like(lse)
        if c_gold is None:
            c_gold = torch.zeros_like(lse)
        dx, dk = kernel_ce_backward(x, w, labels, lse, c_lse, c_gold)
        return dx, dk, None


def _token_loss(lse, gold, amax, labels, ignore_index):
    valid = labels != ignore_index
    n_valid = valid.sum()
    n_correct = ((amax == labels) & valid).sum()
    loss = ((lse - gold) * valid).sum() / torch.clamp(n_valid, min=1)
    return loss, n_valid, n_correct


def kernel_fused_ce(hidden: torch.Tensor, kernel: torch.Tensor,
                    labels: torch.Tensor, num_chunks: int = 8,
                    ignore_index: int = -100):
    """K2 on CUDA tensors: ``hidden [B, S, H] @ kernel [H, V]`` against
    ``labels [B, S]`` -> ``(mean_loss, n_valid, n_correct)``,
    differentiable in ``hidden`` and ``kernel``."""
    del num_chunks
    if hidden.dim() != 3 or tuple(labels.shape) != tuple(hidden.shape[:2]):
        raise ValueError(f"fused CE kernel: hidden must be [B, S, H] and "
                         f"labels [B, S], got {list(hidden.shape)} and "
                         f"{list(labels.shape)}")
    x = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    lse, gold, amax = TokenStats.apply(x, kernel.contiguous(), lab)
    return _token_loss(lse, gold, amax, lab, ignore_index)


def fused_ce_loss(hidden: torch.Tensor, kernel: torch.Tensor,
                  labels: torch.Tensor, num_chunks: int = 8,
                  ignore_index: int = -100):
    """The dispatch seam: ``(mean_loss, n_valid, n_correct)`` of
    ``hidden [B, S, H] @ kernel [H, V]`` against ``labels [B, S]``; the
    kernels for CUDA tensors, :func:`fused_lm_head_ce` for CPU ones."""
    if kernel_choice("fused_ce_fwd", hidden) == "cuda":
        return kernel_fused_ce(hidden, kernel, labels, num_chunks,
                               ignore_index)
    return fused_lm_head_ce(hidden, kernel, labels, num_chunks=num_chunks,
                            ignore_index=ignore_index)


# -- plain versions -------------------------------------------------------

def _scores(x, w):
    """fp32 scores of ``x @ w`` in the inputs' dtype (so bf16 inputs give
    bf16-rounded scores, as the reference's plain version does)."""
    return (x @ w).float()


def torch_ce_token_stats(x, w, labels, chunk: int = PLAIN_CHUNK):
    """Plain K2-fwd: ``(lse, gold, amax)`` per token, ``chunk`` tokens of
    logits at a time; gold is 0 for a label outside ``[0, V)``."""
    vocab = w.shape[1]
    out = []
    for t0 in range(0, x.shape[0], chunk):
        s = _scores(x[t0:t0 + chunk], w)
        lab = labels[t0:t0 + chunk].long()
        inside = (lab >= 0) & (lab < vocab)
        gold = torch.gather(s, 1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
        out.append((torch.logsumexp(s, -1), torch.where(inside, gold, 0.0),
                    s.argmax(-1).int()))
        del s
    return tuple(torch.cat(parts) for parts in zip(*out))


def _plain_d(x, w, labels, lse, c_lse, c_gold):
    s = _scores(x, w)
    d = torch.exp(s - lse.float()[:, None]) * c_lse.float()[:, None]
    cols = torch.arange(w.shape[1], device=x.device)
    hit = cols[None] == labels.long()[:, None]
    return d + hit * c_gold.float()[:, None]


def torch_ce_bwd_dx(x, w, labels, lse, c_lse, c_gold,
                    chunk: int = PLAIN_CHUNK):
    """Plain K2-dx on the kernels' own inputs: ``d K^T`` in x's dtype,
    ``d`` recomputed ``chunk`` tokens at a time."""
    wf = w.float()
    parts = []
    for t0 in range(0, x.shape[0], chunk):
        sl = slice(t0, t0 + chunk)
        d = _plain_d(x[sl], w, labels[sl], lse[sl], c_lse[sl], c_gold[sl])
        parts.append((d @ wf.T).to(x.dtype))
        del d
    return torch.cat(parts)


def torch_ce_bwd_dk(x, w, labels, lse, c_lse, c_gold,
                    chunk: int = PLAIN_CHUNK):
    """Plain K2-dK on the kernels' own inputs: ``x^T d`` summed in fp32
    over chunks of ``chunk`` tokens, in K's dtype."""
    total = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    for t0 in range(0, x.shape[0], chunk):
        sl = slice(t0, t0 + chunk)
        d = _plain_d(x[sl], w, labels[sl], lse[sl], c_lse[sl], c_gold[sl])
        total += x[sl].float().T @ d
        del d
    return total.to(w.dtype)


_SOURCE = "fengshen_tpu_torch/csrc/fused_ce.cu"
FWD = register_kernel(
    "fused_ce_fwd", kernel=cuda_ce_fwd, plain=torch_ce_token_stats,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/fused_ce.py:228")
DX = register_kernel(
    "fused_ce_bwd_dx", kernel=cuda_ce_bwd_dx, plain=torch_ce_bwd_dx,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/fused_ce.py:282")
DK = register_kernel(
    "fused_ce_bwd_dk", kernel=cuda_ce_bwd_dk, plain=torch_ce_bwd_dk,
    source=_SOURCE, replaces="fengshen_tpu/ops/pallas/fused_ce.py:307")
