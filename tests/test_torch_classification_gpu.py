"""The classification path on the card (``gpu``-marked; skipped without
one). This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_classification_gpu.py

A 2-layer ``MegatronBertForSequenceClassification`` at the width of
Erlangshen-MegatronBert-1.3B (``configs/erlangshen_megatron_bert_1.3b.json``:
hidden 2048, 32 heads, intermediate 8192, vocab 21248), forward and
backward in bf16 compute, is held to the same weights run in fp32 compute
on the card, and launches none of the port's kernels K1-K4: the family
runs the dense attention and library GEMMs, as the reference runs it
outside Pallas.

Limits: the bf16 logits within 5e-2 of the fp32 ones (two layers of bf16
rounding, 2^-8 relative per operation, on logits of order one), and
each weight gradient within 5e-2 relative L2 of the fp32 one.
"""

import json
from pathlib import Path

import pytest
import torch

from fengshen_tpu_torch.models.megatron_bert import (
    MegatronBertConfig, MegatronBertForSequenceClassification)
from fengshen_tpu_torch.ops.kernels import _REGISTRY, reset_launch_counts

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "erlangshen_megatron_bert_1.3b.json"
LOGIT_ATOL = 5e-2
GRAD_RTOL = 5e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_layer_erlangshen_bf16_matches_fp32_without_kernels(
        cuda_device):
    raw = json.loads(CONFIG.read_text())
    raw.update(num_hidden_layers=2, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    cfg = MegatronBertConfig(**{k: v for k, v in raw.items()
                                if not k.startswith("_") and
                                k != "model_type"})
    model = MegatronBertForSequenceClassification(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                        device=cuda_device)
    mask = torch.ones_like(ids)
    mask[1, 70:] = 0
    mask[3, 20:] = 0
    types = torch.zeros_like(ids)
    types[:, 40:] = 1
    out = {}
    reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        cfg.dtype = dtype
        model.zero_grad(set_to_none=True)
        logits = model(ids, mask, types)
        assert logits.dtype == getattr(torch, dtype)
        logits.float().square().sum().backward()
        out[dtype] = (logits.detach().float(),
                      {n: p.grad.clone() for n, p in
                       model.named_parameters()})
    torch.cuda.synchronize()
    assert sum(e.launches for e in _REGISTRY.values()) == 0
    (want, want_g), (got, got_g) = out["float32"], out["bfloat16"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < LOGIT_ATOL
    for name, g in want_g.items():
        if g.dim() < 2 or not g.any():
            continue
        rel = ((got_g[name] - g).norm() / g.norm()).item()
        assert rel < GRAD_RTOL, (name, rel)
