"""Rotary position embeddings (the port of ``fengshen_tpu/ops/rotary.py``).

Half-rotation (rotate_half) convention; angles in fp32, cos/sin cast to
the query dtype before they are applied, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch


def rotary_cos_sin(positions: torch.Tensor, dim: int, base: float = 10000.0,
                   dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., S, dim]`` for integer ``positions [..., S]``."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos().to(dtype), angles.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor,
                         positions: torch.Tensor,
                         rotary_dim: Optional[int] = None,
                         base: float = 10000.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE on ``q``/``k`` of shape ``[B, S, H, D]`` at ``positions [B, S]``;
    ``rotary_dim < D`` rotates only the leading ``rotary_dim`` channels."""
    head_dim = q.shape[-1]
    rotary_dim = rotary_dim or head_dim
    cos, sin = rotary_cos_sin(positions, rotary_dim, base=base,
                              dtype=q.dtype)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]

    def rot(x):
        if rotary_dim == head_dim:
            return x * cos + _rotate_half(x) * sin
        x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
        x_rot = x_rot * cos + _rotate_half(x_rot) * sin
        return torch.cat([x_rot, x_pass], dim=-1)

    return rot(q), rot(k)
