"""Attention masks and block-sparse layouts (the port of
``fengshen_tpu/ops/masks.py``: ``causal_mask`` (:27) and the static
block layouts ``bigbird_block_layout`` (:52), ``longformer_block_layout``
(:90) and ``fixed_block_layout`` (:120)).

Masks are boolean ``[Sq, Sk]`` with True = "may attend". A block layout
is a numpy bool ``[n, n]`` block-presence matrix, the form kernel K4
(``ops/kernels/block_sparse_attention.py``) takes; these functions are
numpy copies of the reference's, so one seed gives the same layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def causal_mask(q_len: int, k_len: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Lower-triangular ``[Sq, Sk]``; the queries are the LAST ``q_len``
    positions of the ``k_len`` keys."""
    k_len = k_len or q_len
    q_pos = torch.arange(k_len - q_len, k_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    return k_pos <= q_pos


def _window(layout: np.ndarray, num_window_blocks: int) -> None:
    n = layout.shape[0]
    for off in range(-(num_window_blocks // 2), num_window_blocks // 2 + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        layout[idx, idx + off] = True


def bigbird_block_layout(seq_len: int, block: int, num_random_blocks: int,
                         num_global_blocks: int, num_window_blocks: int,
                         seed: int = 0, causal: bool = False) -> np.ndarray:
    """BigBird: a window of blocks, global rows and columns, and
    ``num_random_blocks`` random blocks per row drawn from
    ``np.random.RandomState(seed)`` (DeepSpeed's BigBirdSparsityConfig)."""
    assert seq_len % block == 0, "seq_len must be a multiple of block"
    n = seq_len // block
    rng = np.random.RandomState(seed)
    layout = np.zeros((n, n), dtype=bool)
    _window(layout, num_window_blocks)
    g = num_global_blocks
    layout[:g, :] = True
    layout[:, :g] = True
    for i in range(n):
        choices = rng.choice(n, size=min(num_random_blocks, n), replace=False)
        layout[i, choices] = True
    if causal:
        layout &= np.tril(np.ones((n, n), dtype=bool))
    return layout


def longformer_block_layout(seq_len: int, block: int, num_window_blocks: int,
                            global_block_indices: tuple[int, ...] = (0,),
                            causal: bool = False) -> np.ndarray:
    """BSLongformer: a window of blocks plus the given global blocks'
    rows and columns."""
    assert seq_len % block == 0
    n = seq_len // block
    layout = np.zeros((n, n), dtype=bool)
    _window(layout, num_window_blocks)
    for gi in global_block_indices:
        layout[gi, :] = True
        layout[:, gi] = True
    if causal:
        layout &= np.tril(np.ones((n, n), dtype=bool))
    return layout


def fixed_block_layout(seq_len: int, block: int, num_local_blocks: int,
                       num_global_blocks: int = 1,
                       causal: bool = True) -> np.ndarray:
    """Fixed sparsity (Sparse Transformers): local stripes of
    ``num_local_blocks`` and periodic global columns; symmetric when not
    causal."""
    assert seq_len % block == 0
    n = seq_len // block
    layout = np.zeros((n, n), dtype=bool)
    stride = num_local_blocks
    for i in range(n):
        blk_start = (i // stride) * stride
        layout[i, blk_start:i + 1] = True          # local window
        layout[i, stride - num_global_blocks::stride] = True  # global cols
    if causal:
        layout &= np.tril(np.ones((n, n), dtype=bool))
    else:
        layout |= layout.T
    return layout
