"""Chunked fused LM-head + cross-entropy: the port of
``fengshen_tpu/ops/fused_ce.py``.

:func:`fused_lm_head_ce` (:26) runs the head matmul and the CE one
sequence chunk at a time, each chunk under ``torch.utils.checkpoint`` so
the backward recomputes that chunk's logits instead of keeping them: at
most one chunk of ``[B, S, V]`` logits is alive. It is the plain version
of kernel K2 (``ops/kernels/fused_ce.py``), which the CPU tests run and
the card holds the kernels against.

As in the reference, the logits are ``(h @ kernel)`` in the inputs'
dtype, then cast to fp32 (:58): with bf16 hidden and head they are
rounded to bf16 before the logsumexp. The kernels keep fp32 scores from
fp32 products instead, so on the card they are held to this function
run in fp32 on the same bf16 inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_stats(h, kernel, lab, ignore_index: int):
    """``(loss_sum, n_valid, n_correct)`` of one chunk: fp32 logits of
    ``h @ kernel``, logsumexp minus the gold logit over the valid labels,
    and first-max argmax hits."""
    logits = (h @ kernel).float()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    loss_sum = ((logz - gold) * valid).sum()
    correct = ((logits.argmax(-1) == lab) & valid).sum()
    return loss_sum, valid.sum(), correct


def fused_lm_head_ce(hidden: torch.Tensor, kernel: torch.Tensor,
                     labels: torch.Tensor, num_chunks: int = 8,
                     ignore_index: int = -100
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hidden [B, S, H] @ kernel [H, V]`` scored against ``labels
    [B, S]`` in ``num_chunks`` sequence chunks. Returns ``(mean_loss,
    n_valid, n_correct)``; the loss is differentiable in ``hidden`` and
    ``kernel``."""
    batch, seq, hid = hidden.shape
    num_chunks = min(num_chunks, seq)
    if seq % num_chunks:
        # pad the token stream to a multiple of num_chunks; the padded
        # rows carry ignore_index and count nowhere
        pad = num_chunks - seq % num_chunks
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
        seq += pad
    chunk = seq // num_chunks
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.long, device=hidden.device)
    n_correct = torch.zeros((), dtype=torch.long, device=hidden.device)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or
                                        kernel.requires_grad)
    for i in range(num_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, lab = hidden[:, sl], labels[:, sl]
        if grad:
            s, n, c = checkpoint(_chunk_stats, h, kernel, lab, ignore_index,
                                 use_reentrant=False)
        else:
            s, n, c = _chunk_stats(h, kernel, lab, ignore_index)
        loss_sum = loss_sum + s
        n_valid = n_valid + n
        n_correct = n_correct + c
    return loss_sum / torch.clamp(n_valid, min=1), n_valid, n_correct


def causal_fused_loss(hidden: torch.Tensor, kernel: torch.Tensor,
                      labels: torch.Tensor, num_chunks: int = 8,
                      ignore_index: int = -100):
    """Shift by one (:79): ``hidden[:, :-1]`` scores ``labels[:, 1:]``."""
    return fused_lm_head_ce(hidden[:, :-1], kernel, labels[:, 1:],
                            num_chunks=num_chunks,
                            ignore_index=ignore_index)
