"""The GPT-2 path on the card (``gpu``-marked; skipped without one). This
file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpt2_gpu.py

- Kernel K2 under GPT-2's tied head: ``CausalLMModule`` in fused-CE mode
  "replicated" on a small GPT-2 (bf16 compute) launches K2's forward,
  dx and dK, and its loss and the gradients of the final hidden states
  (dx) and of ``wte`` (embedding plus head, the head's through the
  transposed view) are held to the same step with K2's plain version.
- Cached greedy decode on ``cuda`` (fp32) against the argmax of one
  uncached forward over the same sequence, launching no kernel (GPT-2's
  decode is dense over its own cache, as the reference's).

Limits: the loss within 2e-3 relative; dx and the ``wte`` gradient
within 2e-2 relative L2 (K2 keeps fp32 scores where the plain version
on bf16 operands rounds them, as in ``test_torch_fused_ce.py``);
greedy tokens equal, or parting only where the uncached forward's top-2
gap is below 1e-4 (fp32 rounding of two summation orders).
"""

from unittest import mock

import pytest
import torch

from fengshen_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from fengshen_tpu_torch.ops.kernels import fused_ce as k2
from fengshen_tpu_torch.ops.kernels import _REGISTRY, reset_launch_counts
from fengshen_tpu_torch.trainer.modules import CausalLMModule
from fengshen_tpu_torch.utils.generate import generate

LOSS_RTOL = 2e-3
GRAD_REL = 2e-2
TIE_MARGIN = 1e-4
K2 = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dk")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(**over):
    kw = dict(vocab_size=1000, n_positions=256, n_embd=256, n_layer=2,
              n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    kw.update(over)
    return GPT2Config(**kw)


@pytest.mark.gpu
def test_k2_under_the_tied_head_matches_its_plain_version(cuda_device):
    cfg = _small(fused_ce_chunks=4, gradient_checkpointing=True)
    model = GPT2LMHeadModel(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    mod = CausalLMModule(None, model, cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen,
                        device=cuda_device)
    mask = torch.ones_like(ids)
    mask[1, 150:] = 0
    labels = torch.where(mask.bool(), ids, -100)
    labels[:, :20] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    hidden = {}

    def keep(module, args, out):
        out.retain_grad()
        hidden["h"] = out

    handle = model.transformer.ln_f.register_forward_hook(keep)
    out = {}
    for route in ("cuda", "plain"):
        model.zero_grad(set_to_none=True)
        reset_launch_counts()
        with mock.patch.object(k2, "kernel_choice",
                               lambda name, t, r=route: r):
            loss = mod.training_loss(batch)[0]
            loss.backward()
            loss = loss.detach()
        torch.cuda.synchronize()
        out[route] = (float(loss), hidden["h"].grad.float().clone(),
                      model.transformer.wte.weight.grad.clone(),
                      {n: _REGISTRY[n].launches for n in K2})
    handle.remove()
    (loss, dx, dw, launches), (ref_loss, ref_dx, ref_dw, plain) = \
        out["cuda"], out["plain"]
    assert launches == {n: 1 for n in K2}
    assert plain == {n: 0 for n in K2}
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    for got, want in ((dx, ref_dx), (dw, ref_dw)):
        assert torch.isfinite(got).all()
        assert ((got - want).norm() / want.norm()).item() < GRAD_REL


@pytest.mark.gpu
def test_cached_decode_matches_an_uncached_forward(cuda_device):
    cfg = _small(dtype="float32")
    model = GPT2LMHeadModel(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(2))
    prompt = torch.randint(3, cfg.vocab_size, (1, 17),
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(3),
                           device=cuda_device)
    reset_launch_counts()
    out = generate(model, prompt, max_new_tokens=24, device=cuda_device)
    with torch.no_grad():
        logits = model(out[:, :-1]).float()[0, prompt.shape[1] - 1:]
    torch.cuda.synchronize()
    assert sum(e.launches + e.dense_calls for e in _REGISTRY.values()) == 0
    new = out[0, prompt.shape[1]:]
    want = logits.argmax(-1)
    if not torch.equal(new, want):
        first = int((new != want).nonzero()[0])
        top = logits[first].topk(2).values
        assert (top[0] - top[1]).item() < TIE_MARGIN, first
        assert logits[first, new[first]] >= top[0] - TIE_MARGIN
