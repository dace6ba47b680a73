"""Attention masks (the port of ``fengshen_tpu/ops/masks.py:27``).

Boolean ``[Sq, Sk]`` with True = "may attend".
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_mask(q_len: int, k_len: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Lower-triangular ``[Sq, Sk]``; the queries are the LAST ``q_len``
    positions of the ``k_len`` keys."""
    k_len = k_len or q_len
    q_pos = torch.arange(k_len - q_len, k_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    return k_pos <= q_pos
