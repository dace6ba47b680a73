"""The compact KL autoencoder: the port of
``fengshen_tpu/models/stable_diffusion/autoencoder_kl.py``.

Image <-> latent with the SD contract (4-channel latents at 1/2^n
resolution, ``SCALING_FACTOR`` 0.18215): a conv encoder of resblocks
with stride-2 ``"SAME"`` downsampling to ``(mean, logvar)``, and a
decoder with nearest upsampling. NCHW; module names are the JAX
module's (``down_0_res``, ``dec_conv_in``), so
``convert.params_from_jax`` maps its tree by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.models.stable_diffusion.unet_sd import (
    Conv, GroupNorm, place_tower, upsample_nearest)

SCALING_FACTOR = 0.18215


@dataclasses.dataclass
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Sequence[int] = (1, 2, 4, 4)
    dtype: str = "float32"

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "VAEConfig":
        base = dict(base_channels=16, channel_mults=(1, 2))
        base.update(overrides)
        return cls(**base)

    def latent_shape(self, image_size: int) -> tuple[int, int, int]:
        """``(C, H, W)`` of the latent of a square image (NCHW; the JAX
        config gives ``(H, W, C)``): one 2x downsample per stage after
        the first."""
        factor = 2 ** (len(self.channel_mults) - 1)
        return (self.latent_channels, image_size // factor,
                image_size // factor)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, channels: int, dtype: str = "float32"):
        super().__init__()
        self.norm1 = GroupNorm(min(8, cin), cin, eps=1e-6)
        self.conv1 = Conv(cin, channels, 3, padding="SAME", dtype=dtype)
        self.norm2 = GroupNorm(min(8, channels), channels, eps=1e-6)
        self.conv2 = Conv(channels, channels, 3, padding="SAME",
                          dtype=dtype)
        self.skip = Conv(cin, channels, 1, dtype=dtype) \
            if cin != channels else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig, device=None, generator=None,
                 init: bool = True):
        super().__init__()
        self.config = cfg = config
        dt, base = cfg.dtype, cfg.base_channels
        mults = list(cfg.channel_mults)
        with torch.device("meta"):
            self.conv_in = Conv(cfg.in_channels, base, 3, padding="SAME",
                                dtype=dt)
            cin = base
            for i, mult in enumerate(mults):
                ch = base * mult
                setattr(self, f"down_{i}_res", _ResBlock(cin, ch, dt))
                if i < len(mults) - 1:
                    setattr(self, f"down_{i}_downsample",
                            Conv(ch, ch, 3, stride=2, padding="SAME",
                                 dtype=dt))
                cin = ch
            self.mid_res = _ResBlock(cin, cin, dt)
            self.norm_out = GroupNorm(min(8, cin), cin, eps=1e-6)
            self.conv_out = Conv(cin, 2 * cfg.latent_channels, 3,
                                 padding="SAME", dtype=dt)
            rev = list(reversed(mults))
            cin = base * rev[0]
            self.dec_conv_in = Conv(cfg.latent_channels, cin, 3,
                                    padding="SAME", dtype=dt)
            self.dec_mid_res = _ResBlock(cin, cin, dt)
            for i, mult in enumerate(rev):
                ch = base * mult
                setattr(self, f"up_{i}_res", _ResBlock(cin, ch, dt))
                if i < len(rev) - 1:
                    setattr(self, f"up_{i}_conv",
                            Conv(ch, ch, 3, padding="SAME", dtype=dt))
                cin = ch
            self.dec_norm_out = GroupNorm(min(8, cin), cin, eps=1e-6)
            self.dec_conv_out = Conv(cin, cfg.in_channels, 3,
                                     padding="SAME", dtype=dt)
        place_tower(self, device, generator, init)

    def encode(self, pixels: torch.Tensor) -> tuple:
        """pixels ``[B, C, H, W]`` -> ``(mean, logvar)`` latents."""
        n = len(self.config.channel_mults)
        h = self.conv_in(pixels)
        for i in range(n):
            h = getattr(self, f"down_{i}_res")(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_res(h)
        stats = self.conv_out(F.silu(self.norm_out(h)))
        mean, logvar = stats.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        n = len(self.config.channel_mults)
        h = self.dec_mid_res(self.dec_conv_in(latent))
        for i in range(n):
            h = getattr(self, f"up_{i}_res")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_conv")(upsample_nearest(h))
        return self.dec_conv_out(F.silu(self.dec_norm_out(h)))

    def forward(self, pixels: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> tuple:
        """``(recon, mean, logvar)``; ``noise`` (the posterior's standard
        normal draw) samples the latent, else the mean is decoded."""
        mean, logvar = self.encode(pixels)
        latent = mean if noise is None else \
            mean + torch.exp(0.5 * logvar) * noise
        return self.decode(latent), mean, logvar
