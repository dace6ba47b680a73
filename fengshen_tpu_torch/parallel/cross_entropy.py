"""Cross entropy: the one-device part of
``fengshen_tpu/parallel/cross_entropy.py``.

:func:`stable_cross_entropy` (:27) is the replicated-logits CE with -100
masking. :func:`vocab_parallel_cross_entropy` (:92) is read on one
device, which is what the reference does when no mesh or no tensor
parallelism is active: it is the same CE. A mesh is not yet ported.
"""

from __future__ import annotations

import torch


def stable_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int = -100
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the targets that are not ``ignore_index``, in fp32.
    Returns ``(mean_loss, n_valid_tokens)``."""
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_targets[..., None].long())[..., 0]
    token_loss = (logz - gold) * valid
    n_valid = torch.clamp(valid.sum(), min=1)
    return token_loss.sum() / n_valid, valid.sum()


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 ignore_index: int = -100
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over logits whose vocab would shard over a tensor axis. On one
    device (the port has no mesh yet) this is :func:`stable_cross_entropy`,
    as in the reference without tensor parallelism."""
    return stable_cross_entropy(logits, targets, ignore_index)
