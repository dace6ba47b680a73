"""Building blocks of the encoder families (BERT, MegatronBert and the
task heads over them), in flax's dtype policy.

The reference's modules are flax ``nn.Dense`` and ``nn.Embed`` with a
compute ``dtype`` over ``param_dtype`` parameters: a Dense casts its
input, kernel and bias to the compute dtype (:func:`dense`), an Embed
casts its rows (:class:`Embed`). Layer norms keep fp32 parameters and
statistics (``ops/norms.LayerNorm``). Module names are the reference's,
so a parameter's name is its flax path joined by ``.`` (``kernel`` read
as ``weight [out, in]``, ``scale`` and ``embedding`` as ``weight``;
``utils/convert_common.flax_to_state``).

The weights of a model are made on its device: its modules are built on
the ``meta`` device and :func:`place` allocates them there and draws
them from a generator (N(0, initializer_range) for projections and
embeddings, biases 0, norms at 1), as the reference's initializers do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.ops.embedding import VocabParallelEmbed
from fengshen_tpu_torch.ops.norms import LayerNorm


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` and so on."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def linear(n_in: int, n_out: int, param_dtype, bias: bool = True
           ) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=bias, dtype=torch_dtype(param_dtype))


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in the compute
    dtype. A LoRA-adapted projection (``ops/lora.LoraLinear``) runs its
    own forward, which merges its weight there."""
    x = x.to(dtype)
    if hasattr(layer, "merged_weight"):
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``weight [N, H]`` in ``param_dtype``, rows
    returned in the compute dtype."""

    def __init__(self, num_embeddings: int, features: int, param_dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=torch_dtype(param_dtype)))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype):
        return F.embedding(ids, self.weight).to(dtype)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 std: float) -> None:
    """Projections (and convolution kernels) and embeddings N(0,
    ``std``) from ``generator``, biases 0, norms at 1; a module with an
    ``init_own_parameters(generator, std)`` method draws its own direct
    parameters (DeBERTa's relative-position table); every other
    parameter (an LM head's bias) is 0. In module order."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            module.weight.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (Embed, VocabParallelEmbed)):
            module.weight.normal_(0.0, std, generator=generator)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif hasattr(module, "init_own_parameters"):
            module.init_own_parameters(generator, std)
        else:
            for p in module.parameters(recurse=False):
                p.zero_()


def place(model: nn.Module, device, generator, init: bool,
          std: float) -> None:
    """Allocate ``model`` (built on ``meta``) on ``device`` (None means
    ``cuda``, raising without a card) and, with ``init``, draw its
    weights from ``generator`` (default: seed 0 on the device)."""
    dev = resolve_device(device)
    model.to_empty(device=dev)
    if not init or dev.type == "meta":
        return
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    init_weights(model, generator, std)


def attention_mask_bool(attention_mask):
    """The reference's mask broadcast: ``[B, S]`` padding masks as
    ``[B, 1, 1, S]``, per-sample ``[B, S, S]`` masks as
    ``[B, 1, S, S]``; nonzero is True (attend)."""
    if attention_mask is None:
        return None
    if attention_mask.dim() == 3:
        return attention_mask[:, None].bool()
    return attention_mask[:, None, None, :].bool()
