"""The compact conditional UNet: the port of
``fengshen_tpu/models/stable_diffusion/unet.py``.

The default tower of ``finetune_taiyi_stable_diffusion`` without
``--faithful_towers`` and the one ``Pipeline(small_test=True)`` builds:
a sinusoidal time embedding through an MLP, one resblock and one
cross-attention block per resolution on the way down (one skip each)
with stride-2 ``"SAME"`` downsampling, a middle block, and the way up
over the skips with nearest upsampling. NCHW; module names are the
JAX module's (``down_0_res``, ``mid_attn``, ``up_1_upconv``), so
``convert.params_from_jax`` maps its tree by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.models.layers import dense, linear, torch_dtype
from fengshen_tpu_torch.models.stable_diffusion.unet_sd import (
    Conv, GroupNorm, attention, place_tower, upsample_nearest)
from fengshen_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 320
    channel_mults: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    cross_attention_dim: int = 768
    dtype: str = "float32"

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "UNetConfig":
        base = dict(base_channels=32, channel_mults=(1, 2), num_heads=2,
                    cross_attention_dim=32)
        base.update(overrides)
        return cls(**base)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """``[cos | sin]`` of the timesteps over ``dim // 2`` frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _groups(channels: int) -> int:
    return min(8, channels)


class _TimeResBlock(nn.Module):
    def __init__(self, cin: int, channels: int, tdim: int,
                 dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        # flax GroupNorm's eps, 1e-6
        self.norm1 = GroupNorm(_groups(cin), cin, eps=1e-6)
        self.conv1 = Conv(cin, channels, 3, padding="SAME", dtype=dtype)
        self.time_proj = linear(tdim, channels, "float32")
        self.norm2 = GroupNorm(_groups(channels), channels, eps=1e-6)
        self.conv2 = Conv(channels, channels, 3, padding="SAME",
                          dtype=dtype)
        self.skip = Conv(cin, channels, 1, dtype=dtype) \
            if cin != channels else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + dense(self.time_proj, F.silu(temb),
                      self.dtype)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class _CrossAttnBlock(nn.Module):
    """LayerNorm (eps 1e-6) over the H*W positions, cross-attention on
    the text states, residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 dtype: str = "float32"):
        super().__init__()
        self.heads = num_heads
        self.dtype = torch_dtype(dtype)
        self.norm = LayerNorm(channels, 1e-6)
        self.to_q = linear(channels, channels, "float32", bias=False)
        self.to_k = linear(context_dim, channels, "float32", bias=False)
        self.to_v = linear(context_dim, channels, "float32", bias=False)
        self.to_out = linear(channels, channels, "float32")

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        dt, hd = self.dtype, c // self.heads
        h = self.norm(x.reshape(b, c, hh * ww).transpose(1, 2))

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        out = attention(split(dense(self.to_q, h, dt)),
                        split(dense(self.to_k, context, dt)),
                        split(dense(self.to_v, context, dt)))
        out = dense(self.to_out, out.transpose(1, 2).reshape(b, -1, c), dt)
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class UNet2DConditionModel(nn.Module):
    """``(latents [B, C_in, H, W], timesteps [B], text states [B, T, D])
    -> predicted noise or velocity [B, C_out, H, W]``."""

    def __init__(self, config: UNetConfig, device=None, generator=None,
                 init: bool = True):
        super().__init__()
        self.config = cfg = config
        dt, base = cfg.dtype, cfg.base_channels
        tdim, ctx = base * 4, cfg.cross_attention_dim
        mults = list(cfg.channel_mults)
        with torch.device("meta"):
            self.time_mlp1 = linear(base, tdim, "float32")
            self.time_mlp2 = linear(tdim, tdim, "float32")
            self.conv_in = Conv(cfg.in_channels, base, 3, padding="SAME",
                                dtype=dt)
            cin, skips = base, []
            for i, mult in enumerate(mults):
                ch = base * mult
                setattr(self, f"down_{i}_res",
                        _TimeResBlock(cin, ch, tdim, dt))
                setattr(self, f"down_{i}_attn",
                        _CrossAttnBlock(ch, cfg.num_heads, ctx, dt))
                skips.append(ch)
                if i < len(mults) - 1:
                    setattr(self, f"down_{i}_downsample",
                            Conv(ch, ch, 3, stride=2, padding="SAME",
                                 dtype=dt))
                cin = ch
            self.mid_res1 = _TimeResBlock(cin, cin, tdim, dt)
            self.mid_attn = _CrossAttnBlock(cin, cfg.num_heads, ctx, dt)
            self.mid_res2 = _TimeResBlock(cin, cin, tdim, dt)
            for i, mult in enumerate(reversed(mults)):
                ch = base * mult
                skip = skips.pop()
                if i > 0:
                    setattr(self, f"up_{i}_upconv",
                            Conv(cin, cin, 3, padding="SAME", dtype=dt))
                setattr(self, f"up_{i}_res",
                        _TimeResBlock(cin + skip, ch, tdim, dt))
                setattr(self, f"up_{i}_attn",
                        _CrossAttnBlock(ch, cfg.num_heads, ctx, dt))
                cin = ch
            self.norm_out = GroupNorm(_groups(cin), cin, eps=1e-6)
            self.conv_out = Conv(cin, cfg.out_channels, 3, padding="SAME",
                                 dtype=dt)
        place_tower(self, device, generator, init)

    def forward(self, latents, timesteps, encoder_hidden_states):
        cfg = self.config
        dt = torch_dtype(cfg.dtype)
        context = encoder_hidden_states.to(dt)
        temb = timestep_embedding(timesteps, cfg.base_channels)
        temb = dense(self.time_mlp2,
                     F.silu(dense(self.time_mlp1, temb, dt)), dt)
        h = self.conv_in(latents)
        skips = []
        n = len(cfg.channel_mults)
        for i in range(n):
            h = getattr(self, f"down_{i}_res")(h, temb)
            h = getattr(self, f"down_{i}_attn")(h, context)
            skips.append(h)  # one skip per resolution level
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res2(h, temb)
        for i in range(n):
            skip = skips.pop()
            if skip.shape[2:] != h.shape[2:]:
                h = getattr(self, f"up_{i}_upconv")(
                    upsample_nearest(h, tuple(skip.shape[2:])))
            h = torch.cat([h, skip], dim=1)
            h = getattr(self, f"up_{i}_res")(h, temb)
            h = getattr(self, f"up_{i}_attn")(h, context)
        return self.conv_out(F.silu(self.norm_out(h)))
