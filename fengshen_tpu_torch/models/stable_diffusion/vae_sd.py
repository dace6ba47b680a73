"""The SD-1.x first-stage VAE (diffusers' ``AutoencoderKL``): the port
of ``fengshen_tpu/models/stable_diffusion/vae_sd.py``.

NCHW, with diffusers' module tree (``encoder.down_blocks.0.resnets.0``,
``quant_conv``, ``post_quant_conv``), so a released
``vae/diffusion_pytorch_model.*`` loads by name. As in the JAX module:
32-group GroupNorm with eps 1e-6, 2 resnets per encoder block and 3 per
decoder block, one single-head spatial attention in each mid block
(``VAEAttention``, whose projections carry biases), the encoder's
downsample padded (0, 1) on the bottom and right only (:114-115), and
the 1x1 ``quant_conv`` / ``post_quant_conv``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.models.layers import dense, linear, torch_dtype
from fengshen_tpu_torch.models.stable_diffusion.unet_sd import (
    Conv, Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D, attention,
    place_tower)

SCALING_FACTOR = 0.18215


@dataclasses.dataclass
class SDVAEConfig:
    """Field names follow diffusers' ``AutoencoderKL`` config."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    dtype: str = "float32"

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "SDVAEConfig":
        base = dict(block_out_channels=(16, 32), layers_per_block=1,
                    norm_num_groups=4)
        base.update(overrides)
        return cls(**base)

    def latent_shape(self, image_size: int) -> tuple[int, int, int]:
        """``(C, H, W)`` of the latent of a square image (NCHW; the JAX
        config gives ``(H, W, C)``)."""
        factor = 2 ** (len(self.block_out_channels) - 1)
        return (self.latent_channels, image_size // factor,
                image_size // factor)


class VAEAttention(nn.Module):
    """diffusers' VAE mid-block attention: its own group norm, one head
    over the H*W positions, biased projections, residual."""

    def __init__(self, channels: int, groups: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = linear(channels, channels, "float32")
        self.to_k = linear(channels, channels, "float32")
        self.to_v = linear(channels, channels, "float32")
        self.to_out = nn.ModuleList([linear(channels, channels, "float32")])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        dt = self.dtype
        h = self.group_norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        out = attention(dense(self.to_q, h, dt)[:, None],
                        dense(self.to_k, h, dt)[:, None],
                        dense(self.to_v, h, dt)[:, None])[:, 0]
        out = dense(self.to_out[0], out, dt)
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class _VAEMidBlock(nn.Module):
    def __init__(self, cfg: SDVAEConfig, channels: int):
        super().__init__()
        g, dt = cfg.norm_num_groups, cfg.dtype
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, g, 1e-6, dtype=dt) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, g, dt)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _EncoderDownBlock(nn.Module):
    def __init__(self, cfg: SDVAEConfig, cin: int, channels: int,
                 is_last: bool):
        super().__init__()
        g, dt = cfg.norm_num_groups, cfg.dtype
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if j == 0 else channels, channels, g, 1e-6, dtype=dt)
            for j in range(cfg.layers_per_block)])
        # diffusers' VAE downsample pads (0, 1): bottom and right only
        self.downsamplers = None if is_last else nn.ModuleList(
            [Downsample2D(channels, pad=((0, 1), (0, 1)), dtype=dt)])

    def forward(self, h):
        for resnet in self.resnets:
            h = resnet(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        return h


class _DecoderUpBlock(nn.Module):
    def __init__(self, cfg: SDVAEConfig, cin: int, channels: int,
                 is_last: bool):
        super().__init__()
        g, dt = cfg.norm_num_groups, cfg.dtype
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if j == 0 else channels, channels, g, 1e-6, dtype=dt)
            for j in range(cfg.layers_per_block + 1)])
        self.upsamplers = None if is_last else nn.ModuleList(
            [Upsample2D(channels, dtype=dt)])

    def forward(self, h):
        for resnet in self.resnets:
            h = resnet(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        dt, chans = cfg.dtype, list(cfg.block_out_channels)
        self.conv_in = Conv(cfg.in_channels, chans[0], 3,
                            padding=((1, 1), (1, 1)), dtype=dt)
        self.down_blocks = nn.ModuleList([_EncoderDownBlock(
            cfg, chans[max(i - 1, 0)], ch, is_last=i == len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = _VAEMidBlock(cfg, chans[-1])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[-1],
                                       eps=1e-6)
        self.conv_out = Conv(chans[-1], 2 * cfg.latent_channels, 3,
                             padding=((1, 1), (1, 1)), dtype=dt)

    def forward(self, pixels):
        h = self.conv_in(pixels)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        dt, rev = cfg.dtype, list(reversed(cfg.block_out_channels))
        self.conv_in = Conv(cfg.latent_channels, rev[0], 3,
                            padding=((1, 1), (1, 1)), dtype=dt)
        self.mid_block = _VAEMidBlock(cfg, rev[0])
        self.up_blocks = nn.ModuleList([_DecoderUpBlock(
            cfg, rev[max(i - 1, 0)], ch, is_last=i == len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1],
                                       eps=1e-6)
        self.conv_out = Conv(rev[-1], cfg.out_channels, 3,
                             padding=((1, 1), (1, 1)), dtype=dt)

    def forward(self, latent):
        h = self.mid_block(self.conv_in(latent))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class SDAutoencoderKL(nn.Module):
    """``encode`` -> the diagonal Gaussian's ``(mean, logvar)``;
    ``decode`` <- latents. The forward contract of the compact tower
    (``autoencoder_kl.AutoencoderKL``)."""

    def __init__(self, config: SDVAEConfig, device=None, generator=None,
                 init: bool = True):
        super().__init__()
        self.config = cfg = config
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = Conv(2 * cfg.latent_channels,
                                   2 * cfg.latent_channels, 1,
                                   dtype=cfg.dtype)
            self.post_quant_conv = Conv(cfg.latent_channels,
                                        cfg.latent_channels, 1,
                                        dtype=cfg.dtype)
        place_tower(self, device, generator, init)

    def encode(self, pixels: torch.Tensor) -> tuple:
        mean, logvar = self.quant_conv(self.encoder(pixels)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(latent))

    def forward(self, pixels: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> tuple:
        """``(recon, mean, logvar)``; ``noise`` (the posterior's standard
        normal draw, shaped as ``mean``) samples the latent, else the
        mean is decoded."""
        mean, logvar = self.encode(pixels)
        latent = mean if noise is None else \
            mean + torch.exp(0.5 * logvar) * noise
        return self.decode(latent), mean, logvar
