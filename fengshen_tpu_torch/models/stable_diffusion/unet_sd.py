"""The SD-1.x UNet (diffusers' ``UNet2DConditionModel``): the port of
``fengshen_tpu/models/stable_diffusion/unet_sd.py``.

The denoiser the released Taiyi-Stable-Diffusion-1B checkpoint ships,
in PyTorch's layout (NCHW) with the module tree of diffusers' state
dict (``down_blocks.0.resnets.1.conv1.weight``), so a released
``unet/diffusion_pytorch_model.*`` loads by name (``convert.py``).
Every detail follows the JAX module: 32-group GroupNorm (eps 1e-5 in
the resnets, 1e-6 in the transformers), the ``flip_sin_to_cos``
timestep embedding (:96-112), attention whose scores are accumulated in
fp32, scaled by ``1/sqrt(head_dim)`` and softmaxed in fp32, then cast
to V's dtype (:158-187), GEGLU with the exact ``gelu`` (:197-207), 1x1
conv ``proj_in`` / ``proj_out``, ``Upsample2D`` as 2x nearest then a 3x3
conv (:273-282), and the down, mid and up blocks with their skip order.

The attention is plain ``matmul`` -> softmax -> ``matmul``, as the JAX
UNet's einsums are (:16-18): SD-1.x heads are 40, 80 and 160 wide, and
no Pallas kernel lies on this path.

The building blocks here (:class:`Conv`, :class:`GroupNorm`,
:class:`ResnetBlock2D`, :class:`Attention`, :class:`Downsample2D`,
:class:`Upsample2D`) are shared with the VAEs. A module computes in its
config's ``dtype`` (convolutions and projections cast input and weight
to it, as flax's ``dtype=`` does) over fp32 parameters; norms keep fp32
statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.layers import dense, linear, torch_dtype
from fengshen_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass
class SDUNetConfig:
    """Field names follow diffusers' ``UNet2DConditionModel`` config;
    the defaults are SD-1.x's (:63-83)."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # = number of heads (SD-1.x quirk)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    dtype: str = "float32"

    @classmethod
    def small_test_config(cls, **overrides: Any) -> "SDUNetConfig":
        base = dict(sample_size=8, block_out_channels=(32, 64),
                    down_block_types=("CrossAttnDownBlock2D",
                                      "DownBlock2D"),
                    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                    layers_per_block=1, cross_attention_dim=32,
                    attention_head_dim=2, norm_num_groups=8)
        base.update(overrides)
        return cls(**base)


# -- building blocks ------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: ``(low, high)``, the
    extra row at the high end (stride 2 on an even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """A 2-D convolution computing in ``dtype`` over fp32 parameters.
    ``padding`` is ``((top, bottom), (left, right))`` or ``"SAME"``
    (flax ``nn.Conv``'s forms); symmetric pads go to the convolution
    itself."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Any = ((0, 0), (0, 0)), dtype: str = "float32"):
        sym = padding != "SAME" and padding[0][0] == padding[0][1] and \
            padding[1][0] == padding[1][1]
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=(padding[0][0], padding[1][0]) if sym
                         else 0)
        self.pads = padding
        self.symmetric = sym
        self.compute_dtype = torch_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if not self.symmetric:
            if self.pads == "SAME":
                k, s = self.kernel_size[0], self.stride[0]
                (t, b), (l, r) = (same_pads(x.shape[2], k, s),
                                  same_pads(x.shape[3], k, s))
            else:
                (t, b), (l, r) = self.pads
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics and parameters, its output in the
    input's dtype (flax ``nn.GroupNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, heads, N, d]``: the
    scores accumulated in fp32, scaled by ``1/sqrt(d)`` in fp32 and
    softmaxed in fp32, the probabilities cast to V's dtype (:170-186)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def upsample_nearest(x: torch.Tensor, size=None) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``: 2x by default; another
    ``size`` takes the half-pixel centres, as JAX's resize does."""
    if size is None:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    return F.interpolate(x, size=size, mode="nearest-exact")


class ResnetBlock2D(nn.Module):
    """diffusers ``ResnetBlock2D``: norm -> silu -> conv twice, the time
    projection between, a learned 1x1 shortcut on a change of width."""

    def __init__(self, cin: int, cout: int, groups: int = 32,
                 eps: float = 1e-5, temb_dim: int = 0,
                 dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        pad = ((1, 1), (1, 1))
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv(cin, cout, 3, padding=pad, dtype=dtype)
        self.time_emb_proj = linear(temb_dim, cout, "float32") \
            if temb_dim else None
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv(cout, cout, 3, padding=pad, dtype=dtype)
        self.conv_shortcut = Conv(cin, cout, 1, dtype=dtype) \
            if cin != cout else None

    def forward(self, x: torch.Tensor, temb=None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + dense(self.time_emb_proj, F.silu(temb),
                          self.dtype)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers ``Attention``: ``to_q`` / ``to_k`` / ``to_v`` (no bias
    in the UNet) and ``to_out.0``, over ``[B, N, C]``."""

    def __init__(self, channels: int, heads: int, context_dim: int = 0,
                 qkv_bias: bool = False, dtype: str = "float32"):
        super().__init__()
        self.heads = heads
        self.dtype = torch_dtype(dtype)
        ctx = context_dim or channels
        self.to_q = linear(channels, channels, "float32", qkv_bias)
        self.to_k = linear(ctx, channels, "float32", qkv_bias)
        self.to_v = linear(ctx, channels, "float32", qkv_bias)
        self.to_out = nn.ModuleList([linear(channels, channels, "float32")])

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        context = x if context is None else context
        dt = self.dtype
        b, n, c = x.shape
        hd = c // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        out = attention(split(dense(self.to_q, x, dt)),
                        split(dense(self.to_k, context, dt)),
                        split(dense(self.to_v, context, dt)))
        return dense(self.to_out[0], out.transpose(1, 2).reshape(b, n, c),
                     dt)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.proj = linear(dim, 2 * inner, "float32")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = dense(self.proj, x, self.dtype).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers ``FeedForward`` with GEGLU: ``net.0.proj`` to twice the
    inner width, ``a * gelu(gate)``, then ``net.2`` (``net.1`` is the
    dropout, which holds no weights)."""

    def __init__(self, dim: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, dtype), nn.Identity(),
                                  linear(4 * dim, dim, "float32")])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.net[2], self.net[0](x), self.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int,
                 dtype: str = "float32"):
        super().__init__()
        # torch's LayerNorm eps, 1e-5 (as the JAX module sets it)
        self.norm1 = LayerNorm(channels, 1e-5)
        self.attn1 = Attention(channels, heads, dtype=dtype)
        self.norm2 = LayerNorm(channels, 1e-5)
        self.attn2 = Attention(channels, heads, context_dim, dtype=dtype)
        self.norm3 = LayerNorm(channels, 1e-5)
        self.ff = FeedForward(channels, dtype)

    def forward(self, x: torch.Tensor, context) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> 1x1 conv ``proj_in`` -> one transformer block over
    the H*W positions -> 1x1 conv ``proj_out``, residual (SD-1.x:
    ``use_linear_projection=False``)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 groups: int = 32, dtype: str = "float32"):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Conv(channels, channels, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, context_dim, dtype)])
        self.proj_out = Conv(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, context) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(b, c, hh * ww).transpose(1, 2)
        h = self.transformer_blocks[0](h, context)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return self.proj_out(h) + x


class Downsample2D(nn.Module):
    """A 3x3 stride-2 conv: torch ``Conv2d(k3, s2, p1)`` in the UNet; the
    VAE pads (0, 1), bottom and right only."""

    def __init__(self, channels: int, pad=((1, 1), (1, 1)),
                 dtype: str = "float32"):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=pad,
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """2x nearest, then a 3x3 conv (:273-282)."""

    def __init__(self, channels: int, dtype: str = "float32"):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=((1, 1), (1, 1)),
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


@torch.no_grad()
def init_tower(model: nn.Module, generator: torch.Generator) -> None:
    """Draw a tower's weights from ``generator`` as flax's defaults are
    drawn: convolution and projection kernels N(0, 1/fan_in) (LeCun
    normal), biases 0, norms at 1. In module order."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.GroupNorm, LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()


def place_tower(model: nn.Module, device, generator, init: bool) -> None:
    """Allocate ``model`` (built on ``meta``) on ``device`` (None means
    ``cuda``, raising without a card) and, with ``init``, draw its
    weights from ``generator`` (default: seed 0 on the device)."""
    dev = resolve_device(device)
    model.to_empty(device=dev)
    if init and dev.type != "meta":
        init_tower(model, generator if generator is not None else
                   torch.Generator(device=dev).manual_seed(0))


def sd_timestep_embedding(timesteps: torch.Tensor, dim: int,
                          flip_sin_to_cos: bool = True,
                          freq_shift: float = 0.0) -> torch.Tensor:
    """diffusers' ``get_timestep_embedding`` (:96-112), in fp32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.linear_1 = linear(cin, dim, "float32")
        self.linear_2 = linear(dim, dim, "float32")

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return dense(self.linear_2,
                     F.silu(dense(self.linear_1, temb, self.dtype)),
                     self.dtype)


# -- blocks ---------------------------------------------------------------

class _DownBlock(nn.Module):
    def __init__(self, cfg: SDUNetConfig, cin: int, channels: int,
                 cross_attn: bool, is_last: bool):
        super().__init__()
        dt, temb = cfg.dtype, cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if j == 0 else channels, channels, cfg.norm_num_groups,
            cfg.norm_eps, temb, dt) for j in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList([Transformer2DModel(
            channels, cfg.attention_head_dim, cfg.cross_attention_dim,
            cfg.norm_num_groups, dt) for _ in range(cfg.layers_per_block)]) \
            if cross_attn else None
        self.downsamplers = None if is_last else nn.ModuleList(
            [Downsample2D(channels, dtype=dt)])

    def forward(self, h, temb, context):
        skips = []
        for j, resnet in enumerate(self.resnets):
            h = resnet(h, temb)
            if self.attentions is not None:
                h = self.attentions[j](h, context)
            skips.append(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
            skips.append(h)
        return h, skips


class _MidBlock(nn.Module):
    def __init__(self, cfg: SDUNetConfig, channels: int):
        super().__init__()
        dt, temb = cfg.dtype, cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, cfg.norm_num_groups, cfg.norm_eps, temb, dt)
            for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2DModel(
            channels, cfg.attention_head_dim, cfg.cross_attention_dim,
            cfg.norm_num_groups, dt)])

    def forward(self, h, temb, context):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context)
        return self.resnets[1](h, temb)


class _UpBlock(nn.Module):
    def __init__(self, cfg: SDUNetConfig, cin: int, skip_channels: list,
                 channels: int, cross_attn: bool, is_last: bool):
        super().__init__()
        dt, temb = cfg.dtype, cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (cin if j == 0 else channels) + skip, channels,
            cfg.norm_num_groups, cfg.norm_eps, temb, dt)
            for j, skip in enumerate(skip_channels)])
        self.attentions = nn.ModuleList([Transformer2DModel(
            channels, cfg.attention_head_dim, cfg.cross_attention_dim,
            cfg.norm_num_groups, dt) for _ in skip_channels]) \
            if cross_attn else None
        self.upsamplers = None if is_last else nn.ModuleList(
            [Upsample2D(channels, dtype=dt)])

    def forward(self, h, skips, temb, context):
        for j, resnet in enumerate(self.resnets):
            h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                h = self.attentions[j](h, context)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class SDUNet2DConditionModel(nn.Module):
    """The SD-1.x denoiser: ``(latents [B, C, H, W], timesteps [B], text
    states [B, T, D]) -> noise [B, C_out, H, W]``. ``device=None`` means
    ``cuda`` and raises without a card; the weights are drawn there from
    ``generator`` (:func:`init_tower`)."""

    def __init__(self, config: SDUNetConfig, device=None,
                 generator=None, init: bool = True):
        super().__init__()
        self.config = cfg = config
        dt = cfg.dtype
        ch0 = cfg.block_out_channels[0]
        n = len(cfg.block_out_channels)
        with torch.device("meta"):
            self.time_embedding = TimestepEmbedding(ch0, ch0 * 4, dt)
            self.conv_in = Conv(cfg.in_channels, ch0, 3,
                                padding=((1, 1), (1, 1)), dtype=dt)
            skip_ch, cin = [ch0], ch0
            self.down_blocks = nn.ModuleList()
            for i, (btype, ch) in enumerate(zip(cfg.down_block_types,
                                                cfg.block_out_channels)):
                self.down_blocks.append(_DownBlock(
                    cfg, cin, ch, btype == "CrossAttnDownBlock2D",
                    is_last=i == n - 1))
                skip_ch += [ch] * (cfg.layers_per_block +
                                   (0 if i == n - 1 else 1))
                cin = ch
            self.mid_block = _MidBlock(cfg, cfg.block_out_channels[-1])
            self.up_blocks = nn.ModuleList()
            for i, (btype, ch) in enumerate(zip(
                    cfg.up_block_types, reversed(cfg.block_out_channels))):
                skips = [skip_ch.pop()
                         for _ in range(cfg.layers_per_block + 1)]
                self.up_blocks.append(_UpBlock(
                    cfg, cin, skips, ch, btype == "CrossAttnUpBlock2D",
                    is_last=i == n - 1))
                cin = ch
            self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0,
                                           eps=cfg.norm_eps)
            self.conv_out = Conv(ch0, cfg.out_channels, 3,
                                 padding=((1, 1), (1, 1)), dtype=dt)
        place_tower(self, device, generator, init)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        context = encoder_hidden_states.to(torch_dtype(cfg.dtype))
        temb = self.time_embedding(sd_timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
            cfg.freq_shift))
        h = self.conv_in(latents)
        skips = [h]
        for block in self.down_blocks:
            h, block_skips = block(h, temb, context)
            skips.extend(block_skips)
        h = self.mid_block(h, temb, context)
        for block in self.up_blocks:
            h = block(h, skips, temb, context)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
