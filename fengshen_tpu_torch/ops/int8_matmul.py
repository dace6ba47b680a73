"""int8 KV quantization: the port of ``quantize_kv`` (:39) and
``dequantize_kv`` (:53) of ``fengshen_tpu/ops/int8_matmul.py``.

One fp32 absmax scale per (token, head) vector: the serving pool stores
1 byte per element plus one float per head (``serving/paged_cache.py``,
``modeling_llama._update_cache``). The arithmetic is the reference's
op for op (an fp32 true division, round half to even, a clip to
+-127), so the int8 values and scales are bitwise the JAX package's.
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., head_dim]`` K/V -> (int8 values, fp32 scale ``[...]``)."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.clamp(absmax.float(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, rounded to ``dtype`` (the model's
    compute dtype, as the reference's attention read rounds it)."""
    return (q.float() * scale[..., None]).to(dtype)
