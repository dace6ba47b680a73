"""Kernel K2 (fused LM-head cross-entropy) of the port against the JAX
package.

On the CPU the port's plain version (``ops/fused_ce.fused_lm_head_ce``,
which the seam ``fused_ce_loss`` takes for CPU tensors) is held against
the reference's ``fused_lm_head_ce`` and against the Pallas TPU kernels
run in interpret mode (``pallas_fused_ce(..., interpret=True)``), at the
sizes of ``tests/test_pallas_kernels.py _ce_case`` (T = 16 tokens,
H = 128, V = 256): loss, ``n_valid``, ``n_correct`` and the gradients in
hidden and head, with ignored rows, labels forced onto the argmax, and
an odd token count that the chunking pads. The three kernels' own plain
versions (per-token lse / gold / argmax; dx and dK for given cotangents)
are held against the Pallas kernels' functions.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 (the two sum the same fp32
products in another order, ~1e-7 relative; a wrong mask, shift or
cotangent moves results by far more). bf16: both round the logits to
bf16 before the logsumexp, from fp32 sums in another order, so a logit
may land one bf16 ulp (2^-8 relative) apart: the loss within 2e-3
absolute, gradients within 2^-6 of each tensor's largest value.

The CUDA kernels run only on the card: the tests marked ``gpu`` skip
without one. JAX is imported inside the CPU tests, so the card's machine
(which has none) runs the gpu tests with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_ce.py``.
"""

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.ops.fused_ce import (causal_fused_loss,
                                             fused_lm_head_ce)
from fengshen_tpu_torch.ops.kernels import get_entry
from fengshen_tpu_torch.ops.kernels.fused_ce import (
    check_eligible, fused_ce_loss, kernel_ce_backward, kernel_fused_ce,
    torch_ce_bwd_dk, torch_ce_bwd_dx, torch_ce_token_stats)
from fengshen_tpu_torch.parallel.cross_entropy import fused_vocab_parallel_ce

F32 = dict(rtol=1e-5, atol=1e-6)
K2_NAMES = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dk")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, batch=2, seq=8, hid=128, vocab=256):
    """``_ce_case`` in numpy: hidden and head at scale 0.1, two ignored
    labels in row 0 and three labels set to the argmax in row 1."""
    rng = np.random.RandomState(seed)
    hidden = (rng.randn(batch, seq, hid) * 0.1).astype(np.float32)
    kernel = (rng.randn(hid, vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels[0, :2] = -100
    greedy = (hidden.astype(np.float64) @ kernel).argmax(-1)
    labels[1, :3] = greedy[1, :3]
    return hidden, kernel, labels


def _torch_loss(fn, hidden, kernel, labels, dtype=torch.float32, **kw):
    """``fn``'s (loss, n_valid, n_correct) and its gradients in hidden
    and head, all as numpy (fp32)."""
    h = torch.tensor(hidden, dtype=dtype, requires_grad=True)
    k = torch.tensor(kernel, dtype=dtype, requires_grad=True)
    loss, n, c = fn(h, k, torch.tensor(labels).long(), **kw)
    loss.backward()
    return (loss.item(), int(n), int(c), h.grad.float().numpy(),
            k.grad.float().numpy())


def _jax_loss(fn, hidden, kernel, labels, dtype="float32", **kw):
    import jax
    import jax.numpy as jnp

    def f(h, k):
        loss, n, c = fn(h, k, jnp.asarray(labels), **kw)
        return loss, (n, c)

    h, k = (jnp.asarray(a, getattr(jnp, dtype)) for a in (hidden, kernel))
    (loss, (n, c)), (gh, gk) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(h, k)
    return (float(loss), int(n), int(c), np.asarray(gh, np.float32),
            np.asarray(gk, np.float32))


def _assert_same(got, want, loss_tol, grad_tol):
    assert got[1:3] == want[1:3]            # n_valid, n_correct exact
    assert got[0] == pytest.approx(want[0], **loss_tol)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, **grad_tol)


@pytest.fixture(scope="module")
def jax_refs():
    """The reference's results per case, computed once."""
    from fengshen_tpu.ops.fused_ce import causal_fused_loss as jax_causal
    from fengshen_tpu.ops.fused_ce import fused_lm_head_ce as jax_fused
    from fengshen_tpu.ops.pallas.fused_ce import pallas_fused_ce
    out = {}
    h, k, lab = _case(11)
    out["fused"] = _jax_loss(jax_fused, h, k, lab, num_chunks=4)
    out["pallas"] = _jax_loss(pallas_fused_ce, h, k, lab, interpret=True)
    out["causal_odd"] = _jax_loss(jax_causal, h, k, lab, num_chunks=4)
    out["bf16"] = _jax_loss(jax_fused, h, k, lab, dtype="bfloat16",
                            num_chunks=4)
    ignored = np.full_like(lab, -100)
    out["all_ignored"] = _jax_loss(jax_fused, h, k, ignored, num_chunks=4)
    return out


def test_plain_matches_jax_fused_lm_head_ce(jax_refs):
    h, k, lab = _case(11)
    got = _torch_loss(fused_lm_head_ce, h, k, lab, num_chunks=4)
    assert got[2] >= 3                      # the forced argmax hits count
    _assert_same(got, jax_refs["fused"], dict(rel=1e-5), F32)


def test_plain_matches_pallas_interpret(jax_refs):
    """The plain version against what the Pallas kernels compute."""
    h, k, lab = _case(11)
    got = _torch_loss(fused_lm_head_ce, h, k, lab, num_chunks=4)
    _assert_same(got, jax_refs["pallas"], dict(rel=1e-5), F32)


def test_causal_shift_with_odd_token_count(jax_refs):
    """``causal_fused_loss`` scores 2 x 7 tokens in 4 chunks: the token
    stream is padded with ignored rows, which count nowhere."""
    h, k, lab = _case(11)
    got = _torch_loss(causal_fused_loss, h, k, lab, num_chunks=4)
    _assert_same(got, jax_refs["causal_odd"], dict(rel=1e-5), F32)


def test_bf16_rounds_the_logits_as_jax_does(jax_refs):
    h, k, lab = _case(11)
    got = _torch_loss(fused_lm_head_ce, h, k, lab, dtype=torch.bfloat16,
                      num_chunks=4)
    want = jax_refs["bf16"]
    assert got[1:3] == want[1:3]
    assert got[0] == pytest.approx(want[0], abs=2e-3)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 ** -6 * np.abs(w).max())


def test_every_label_ignored_gives_zero(jax_refs):
    h, k, lab = _case(11)
    got = _torch_loss(fused_lm_head_ce, h, k, np.full_like(lab, -100),
                      num_chunks=4)
    assert got[:3] == (0.0, 0, 0)
    _assert_same(got, jax_refs["all_ignored"], dict(abs=0), F32)


def test_seam_takes_the_plain_version_on_cpu():
    """``fused_ce_loss`` on CPU tensors is ``fused_lm_head_ce``, bitwise,
    and launches nothing."""
    h, k, lab = (torch.from_numpy(a) for a in _case(12))
    before = [get_entry(n).launches for n in K2_NAMES]
    seam = fused_ce_loss(h, k, lab.long(), num_chunks=4)
    plain = fused_lm_head_ce(h, k, lab.long(), num_chunks=4)
    for a, b in zip(seam, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [get_entry(n).launches for n in K2_NAMES] == before


def test_fused_vocab_parallel_ce_without_a_mesh_matches_jax():
    from fengshen_tpu.parallel.cross_entropy import (
        fused_vocab_parallel_ce as jax_fvp)
    h, k, lab = _case(13, hid=16, vocab=64)
    got = _torch_loss(fused_vocab_parallel_ce, h, k, lab, num_chunks=4)
    want = _jax_loss(jax_fvp, h, k, lab, num_chunks=4)
    _assert_same(got, want, dict(rel=1e-5), F32)

    class Mesh:
        shape = {"data": 1, "tensor": 2}

    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        fused_vocab_parallel_ce(*(torch.from_numpy(a) for a in (h, k)),
                                torch.from_numpy(lab).long(), mesh=Mesh())


def _pallas_token_stats(x, kernel, labels, c_lse, c_gold):
    """The Pallas kernels' functions in interpret mode: (lse, gold, amax)
    and the VJP (dx, dK) for cotangents (c_lse, c_gold)."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.ops.pallas.fused_ce import _token_stats
    lab = jnp.asarray(labels)
    stats = _token_stats(jnp.asarray(x), jnp.asarray(kernel), lab, 8, 128,
                         True)
    _, vjp = jax.vjp(lambda a, b: _token_stats(a, b, lab, 8, 128, True)[:2],
                     jnp.asarray(x), jnp.asarray(kernel))
    dx, dk = vjp((jnp.asarray(c_lse), jnp.asarray(c_gold)))
    return [np.asarray(s) for s in stats] + [np.asarray(dx), np.asarray(dk)]


def test_kernel_plain_versions_match_pallas_kernels():
    """Plain K2-fwd / K2-dx / K2-dK against ``_token_stats`` and its VJP
    (the three Pallas kernels, interpret mode), with ignored labels, a
    label past the vocab (gold 0: no column matches) and arbitrary
    cotangents; the chunked plain versions at a chunk that splits the
    tokens unevenly."""
    h, k, lab = _case(14)
    x, labels = h.reshape(16, 128), lab.reshape(16)
    labels[5] = 256 + 3
    rng = np.random.RandomState(15)
    c_lse, c_gold = (rng.randn(16).astype(np.float32) for _ in range(2))
    lse, gold, amax, dx, dk = _pallas_token_stats(x, k, labels, c_lse,
                                                  c_gold)
    xt, kt, lt = (torch.from_numpy(a) for a in (x, k, labels))
    got = torch_ce_token_stats(xt, kt, lt, chunk=5)
    np.testing.assert_allclose(got[0].numpy(), lse, **F32)
    np.testing.assert_allclose(got[1].numpy(), gold, **F32)
    np.testing.assert_array_equal(got[2].numpy(), amax)
    assert gold[5] == 0 and got[1][5] == 0
    cl, cg = torch.from_numpy(c_lse), torch.from_numpy(c_gold)
    np.testing.assert_allclose(
        torch_ce_bwd_dx(xt, kt, lt, got[0], cl, cg, chunk=5).numpy(), dx,
        **F32)
    np.testing.assert_allclose(
        torch_ce_bwd_dk(xt, kt, lt, got[0], cl, cg, chunk=5).numpy(), dk,
        **F32)


@pytest.mark.parametrize("bad,match", [
    ("hidden", "head is"), ("dtype", "bf16 or fp32"),
    ("labels", "int32"), ("device", "CUDA"),
])
def test_check_eligible_names_what_the_kernels_refuse(bad, match):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 16)
    lab = torch.zeros(4, dtype=torch.int32)
    if bad == "hidden":
        w = torch.zeros(6, 16)
    elif bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "labels":
        lab = lab.long()
    with pytest.raises(ValueError, match=match):
        check_eligible(x, w, lab)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _worst_ratio(got, want, rtol):
    """The largest |got - want| / (rtol (|want| + rms of want's row) +
    1e-4 x want's rms): at most 1 where every element is within
    tolerance."""
    row_rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    floor = 1e-4 * want.pow(2).mean().sqrt() + 1e-30
    diff = (got.float() - want).abs()
    return (diff / (rtol * (want.abs() + row_rms) + floor)).max().item()


def _gpu_case(n_tok, hid, vocab, dtype, device, seed=0):
    """x, head and labels on the card: labels with ignored rows, a label
    past the vocab, and a quarter set to the argmax."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n_tok, hid, generator=gen)
    w = torch.randn(hid, vocab, generator=gen) * hid ** -0.5
    labels = torch.randint(0, vocab, (n_tok,), generator=gen)
    labels[::7] = -100
    labels[1::11] = vocab + 2
    labels[2::4] = (x.double() @ w.double()).argmax(-1)[2::4]
    return (x.to(device, dtype), w.to(device, dtype),
            labels.to(device, torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tok,hid,vocab,chunk", [
    (1, 64, 1, 1024), (127, 200, 1000, 1024), (300, 128, 777, 64),
    (513, 256, 4096, 128), (257, 203, 1001, 128)])
def test_cuda_kernels_match_plain(cuda_device, dtype, n_tok, hid, vocab,
                                  chunk):
    """K2-fwd, K2-dx and K2-dK against their plain versions run in fp32
    on the same (dtype-rounded) inputs, at ragged shapes (no tile of 128
    divides T, H or V) and with the backward split into chunks that do
    not divide T. lse and gold fp32: within 1e-4 of the row's scale (sums
    in another order); amax exact but for near-ties (top-2 gap < 1e-4);
    dx and dK element-wise within rtol x (|want| + rms of want's row):
    fp32 1e-4, bf16 2^-7 (the outputs are rounded to bf16). The last
    shape has H and V that are not multiples of 8, so the bf16 kernels
    stage every row of x, the head and d element by element."""
    x, w, labels = _gpu_case(n_tok, hid, vocab, dtype, cuda_device)
    before = [get_entry(n).launches for n in K2_NAMES]
    from fengshen_tpu_torch.ops.kernels.fused_ce import cuda_ce_fwd
    lse, gold, amax = cuda_ce_fwd(x, w, labels)
    gen = torch.Generator(device="cpu").manual_seed(1)
    c_lse = torch.randn(n_tok, generator=gen).to(cuda_device)
    c_gold = torch.randn(n_tok, generator=gen).to(cuda_device)
    dx, dk = kernel_ce_backward(x, w, labels, lse, c_lse, c_gold,
                                chunk=chunk)
    torch.cuda.synchronize()
    n_chunks = -(-n_tok // chunk)
    assert [get_entry(n).launches - b for n, b in zip(K2_NAMES, before)] \
        == [1, n_chunks, n_chunks]
    xf, wf = x.float(), w.float()
    ref_lse, ref_gold, ref_amax = torch_ce_token_stats(xf, wf, labels)
    scale = ref_lse.abs().max().item() + 1.0
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * scale
    assert (gold - ref_gold).abs().max().item() <= 1e-4 * scale
    assert ((labels < 0) | (labels >= vocab)).any()
    assert (gold[(labels < 0) | (labels >= vocab)] == 0).all()
    s = xf @ wf
    top2 = s.topk(min(2, vocab), -1).values
    gap = top2[:, 0] - top2[:, -1]
    wrong = amax != ref_amax
    assert (gap[wrong] < 1e-4).all()
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    ref_dx = torch_ce_bwd_dx(xf, wf, labels, lse, c_lse, c_gold)
    ref_dk = torch_ce_bwd_dk(xf, wf, labels, lse, c_lse, c_gold)
    assert _worst_ratio(dx, ref_dx, rtol) <= 1.0
    assert _worst_ratio(dk, ref_dk, rtol) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_seam_loss_and_grads(cuda_device, dtype):
    """The seam on CUDA tensors (``TokenStats`` through autograd) against
    the plain version in fp32 on the same inputs, every label ignored
    included (loss 0, n_valid 0, zero gradients). Labels stay inside the
    vocab or -100 here: the plain version gathers the gold logit."""
    x, w, labels = _gpu_case(300, 128, 777, dtype, cuda_device, seed=3)
    labels = torch.where(labels >= 777, 5, labels)
    hidden = x.view(3, 100, 128).clone().requires_grad_(True)
    head = w.clone().requires_grad_(True)
    lab = labels.view(3, 100).long()
    loss, n, c = fused_ce_loss(hidden, head, lab)
    loss.backward()
    hf = hidden.detach().float().requires_grad_(True)
    wf = head.detach().float().requires_grad_(True)
    ref, ref_n, ref_c = fused_lm_head_ce(hf, wf, lab)
    ref.backward()
    assert int(n) == int(ref_n)
    assert abs(int(c) - int(ref_c)) <= 1
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    assert _worst_ratio(hidden.grad.view(300, 128), hf.grad.view(300, 128),
                        rtol) <= 1.0
    assert _worst_ratio(head.grad, wf.grad, rtol) <= 1.0
    ignored = torch.full_like(lab, -100)
    hidden.grad = head.grad = None
    loss, n, c = kernel_fused_ce(hidden, head, ignored)
    loss.backward()
    assert (float(loss), int(n), int(c)) == (0.0, 0, 0)
    assert not hidden.grad.any() and not head.grad.any()
