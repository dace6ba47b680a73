"""Kernel K1 (flash attention) of the port against the JAX package.

On the CPU the port's dispatch ``flash_attention`` (which takes the plain
version, ``blockwise_attention``, for CPU tensors) is held against the
reference's ``blockwise_attention`` and against the Pallas TPU kernels
run in interpret mode at ``blk_q = blk_k = 8``, as ``tests/test_ops.py``
runs them: the forward, then dq/dk/dv (``jax.vjp`` against
``torch.autograd``) for the same cotangent, over causal, segment ids from
a right-padded mask, and GQA. fp32, atol/rtol 2e-5: the three sum the
online softmax over blocks of different sizes (512 here, 8 in the Pallas
kernel), which moves fp32 results by a few 1e-7; a wrong mask or scale
moves them by far more.

The CUDA kernels run only on the card: the tests marked ``gpu`` skip
without one. JAX is imported inside the CPU tests, so the card's machine
(which has none) runs the gpu tests with
``python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.ops.flash_attention import flash_attention
from fengshen_tpu_torch.ops.kernels import get_entry
from fengshen_tpu_torch.ops.kernels.flash_attention import (
    attention_delta, check_eligible, kernel_flash_attention,
    torch_flash_backward, torch_flash_bwd, torch_flash_forward)

TOL = dict(atol=2e-5, rtol=2e-5)
CASES = {                      # causal, segment ids, (H, KVH)
    "causal": (True, False, (4, 4)),
    "causal_seg": (True, True, (4, 4)),
    "causal_seg_gqa": (True, True, (4, 2)),
    "full_gqa": (False, False, (4, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, batch=2, seq=16, head_dim=16, seed=0):
    """numpy operands: q, k, v, the cotangent, and segment ids from a
    right-padded attention mask (pads are segment 0) or None."""
    causal, seg, (heads, kv_heads) = CASES[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(batch, seq, heads, head_dim).astype(np.float32)
    k = rng.randn(batch, seq, kv_heads, head_dim).astype(np.float32)
    v = rng.randn(batch, seq, kv_heads, head_dim).astype(np.float32)
    g = rng.randn(batch, seq, heads, head_dim).astype(np.float32)
    ids = None
    if seg:
        lengths = [seq - 5, seq][:batch] + [seq // 2] * max(0, batch - 2)
        ids = np.zeros((batch, seq), np.int32)
        for b, n in enumerate(lengths):
            ids[b, :n] = 1
    return causal, q, k, v, g, ids


@pytest.fixture(scope="module")
def jax_results():
    """Per case: (blockwise out, grads) and (Pallas interpret out, grads,
    lse), computed once."""
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.ops.flash_attention import blockwise_attention
    from fengshen_tpu.ops.pallas.flash_attention import (
        _fwd_impl, pallas_flash_attention)

    out = {}
    for name in CASES:
        causal, q, k, v, g, ids = _case(name)
        seg = None if ids is None else jnp.asarray(ids)
        rep = q.shape[2] // k.shape[2]

        def blockwise(q, k, v):
            return blockwise_attention(
                q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
                causal=causal, q_segment_ids=seg, kv_segment_ids=seg)

        def pallas(q, k, v):
            return pallas_flash_attention(q, k, v, seg, seg, causal, 8, 8,
                                          True)

        res = {}
        for key, fn in (("blockwise", blockwise), ("pallas", pallas)):
            o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v))
            res[key] = (np.asarray(o),
                        [np.asarray(x) for x in vjp(jnp.asarray(g))])
        tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
        _, lse = _fwd_impl(tr(q), tr(k), tr(v), seg, seg, causal, 8, 8,
                           True)
        res["lse"] = np.asarray(lse)[:, :, 0, :]
        out[name] = res
    return out


def _port(name):
    causal, q, k, v, g, ids = _case(name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    seg = None if ids is None else torch.from_numpy(ids)
    out = flash_attention(tq, tk, tv, causal=causal, segment_ids=seg)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    return causal, out.detach().numpy(), [x.numpy() for x in grads], seg


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ref", ["blockwise", "pallas"])
def test_forward_and_grads_match_jax(jax_results, name, ref):
    _, out, grads, _ = _port(name)
    jax_out, jax_grads = jax_results[name][ref]
    np.testing.assert_allclose(out, jax_out, **TOL)
    for got, want, what in zip(grads, jax_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_matches_pallas(jax_results, name):
    """The log-sum-exp the kernels save for the backward: the plain
    version's equals the Pallas forward's residual."""
    causal, q, k, v, _, ids = _case(name)
    seg = None if ids is None else torch.from_numpy(ids)
    _, lse = torch_flash_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 seg, seg, causal)
    np.testing.assert_allclose(lse.numpy(), jax_results[name]["lse"], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_kernel_backward_matches_pallas(jax_results, name):
    """The plain versions of K1-dkv and K1-dq, which take the forward's
    lse and delta = rowsum(dO * O) as the kernels do, give the Pallas
    kernels' dq, dk and dv."""
    causal, q, k, v, g, ids = _case(name)
    seg = None if ids is None else torch.from_numpy(ids)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = torch_flash_forward(tq, tk, tv, seg, seg, causal)
    grads = torch_flash_bwd(tq, tk, tv, tg, lse, attention_delta(out, tg),
                            seg, seg, causal)
    for got, want, what in zip(grads, jax_results[name]["pallas"][1],
                               ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)


def test_plain_kernel_backward_row_with_no_valid_key():
    """A row with no valid key (lse -1e30) adds dO / Sk to every key's
    dV and nothing else, as autograd through the plain version gives."""
    _, q, k, v, g, _ = _case("causal_seg_gqa", seq=8)
    q_ids = np.ones((2, 8), np.int32)
    q_ids[1, 3] = 7
    qs, ks = torch.from_numpy(q_ids), torch.ones(2, 8, dtype=torch.int32)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = torch_flash_forward(tq, tk, tv, qs, ks, False)
    assert lse[1, :, 3].eq(-1e30).all()
    grads = torch_flash_bwd(tq, tk, tv, tg, lse, attention_delta(out, tg),
                            qs, ks, False)
    want = torch_flash_backward(tq, tk, tv, tg, qs, ks, False)
    for got, ref, what in zip(grads, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=what,
                                   **TOL)
    assert grads[0][1, 3].eq(0).all()


def test_causal_padded_rows_always_have_their_diagonal():
    """Pads are segment 0 and attend to pads, so under causal masking
    every row, pad or not, keeps at least its own position: no row of a
    right-padded batch is left with no valid key."""
    causal, q, k, v, _, ids = _case("causal_seg", batch=3, seq=24)
    seg = torch.from_numpy(ids)
    _, lse = torch_flash_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 seg, seg, causal)
    assert (ids == 0).any() and (lse > -1e29).all()


def test_row_with_no_valid_key_matches_jax():
    """A query whose segment has no key (possible with separate q and kv
    ids) gets the uniform average of all values, as in the reference."""
    import jax.numpy as jnp

    from fengshen_tpu.ops.flash_attention import blockwise_attention
    _, q, k, v, _, _ = _case("causal", seq=8)
    q_ids = np.ones((2, 8), np.int32)
    q_ids[1, 3] = 7                       # no key carries segment 7
    kv_ids = np.ones((2, 8), np.int32)
    ref = blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), q_segment_ids=q_ids,
                              kv_segment_ids=kv_ids)
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          segment_ids=(torch.from_numpy(q_ids),
                                       torch.from_numpy(kv_ids)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out[1, 3].numpy(), v[1].mean(0), **TOL)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    causal, q, k, v, g, ids = _case("causal_seg_gqa")
    entries = [get_entry(n) for n in ("flash_attention_fwd",
                                      "flash_attention_bwd_dkv",
                                      "flash_attention_bwd_dq")]
    before = [e.launches for e in entries]
    _port("causal_seg_gqa")
    assert [e.launches for e in entries] == before
    # autograd of the plain version, which the card also holds K1 to
    seg = torch.from_numpy(ids)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    _, grads, _ = _port("causal_seg_gqa")[1:]
    plain = torch_flash_backward(tq, tk, tv, tg, seg, seg, causal)
    for got, want in zip(grads, plain):
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=0)


def test_dropout_is_refused():
    _, q, k, v, _, _ = _case("causal")
    with pytest.raises(ValueError, match="dropout"):
        flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        dropout_rate=0.1, deterministic=False)


@pytest.mark.parametrize("change,match", [
    (dict(head_dim=96), "head_dim"),
    (dict(heads=(6, 4)), "multiple of KVH"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(seg_shape=(2, 5)), "segment ids"),
    (dict(), "CUDA device"),
])
def test_kernel_rules(change, match):
    """Shapes outside the kernels' rules raise (never a silent fallback);
    the rules are checked before the device, so an eligible CPU shape
    stops only at the device check."""
    heads, kv_heads = change.get("heads", (4, 2))
    head_dim = change.get("head_dim", 64)
    dtype = change.get("dtype", torch.bfloat16)
    q = torch.zeros(2, 8, heads, head_dim, dtype=dtype)
    k = torch.zeros(2, 8, kv_heads, head_dim, dtype=dtype)
    seg = torch.zeros(change.get("seg_shape", (2, 8)), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        check_eligible(q, k, k.clone(), seg, seg)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _worst_ratio(got, want, rtol):
    """The largest |got - want| / (rtol (|want| + rms of want's head_dim
    row) + 1e-4 x want's rms): at most 1 where every element is within
    tolerance (the last term covers rows that are zero, such as dq's
    first causal row, where fp32 sums in another order leave ~1e-6)."""
    row_rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    floor = 1e-4 * want.pow(2).mean().sqrt()
    diff = (got.float() - want).abs()
    return (diff / (rtol * (want.abs() + row_rms) + floor)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,head_dim", [(100, 64), (256, 128),
                                          ((77, 200), 128)])
def test_cuda_kernels_match_plain(cuda_device, name, dtype, seq, head_dim):
    """K1-fwd, K1-dkv and K1-dq against their plain versions on the card,
    at a ragged length (100: tiles of 64 with an edge), a tiled one, and
    77 queries over 200 keys (``seq`` as ``(Sq, Sk)``: the queries are the
    last 77 positions, right-aligned for the causal mask, with their
    segment ids), ragged on both sides of the 64-row tiles.
    The plain versions run in fp32 on the same (dtype-rounded) inputs;
    the backward's take the kernels' own lse and delta. Each element
    within rtol x (|want| + rms of its head_dim row): fp32 1e-4 (sums
    in another order, fast exp), bf16 2^-7 (the outputs are rounded to
    bf16, at most 2^-8 relative). A kernel that skips a tile moves a
    row by tens of percent."""
    q_len, k_len = seq if isinstance(seq, tuple) else (seq, seq)
    causal, q, k, v, g, ids = _case(name, batch=3, seq=k_len,
                                    head_dim=head_dim, seed=5)
    q, g = q[:, k_len - q_len:], g[:, k_len - q_len:]
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
            .to(dtype) for x in (q, k, v, g)]
    kv_seg = None if ids is None else torch.from_numpy(ids).to(cuda_device)
    seg = None if ids is None else kv_seg[:, k_len - q_len:].contiguous()
    entries = [get_entry(n) for n in ("flash_attention_fwd",
                                      "flash_attention_bwd_dkv",
                                      "flash_attention_bwd_dq")]
    before = [e.launches for e in entries]
    tq, tk, tv = (a.clone().requires_grad_(True) for a in args[:3])
    out = kernel_flash_attention(tq, tk, tv, seg, kv_seg, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), args[3])
    torch.cuda.synchronize()
    assert [e.launches - b for e, b in zip(entries, before)] == [1, 1, 1]
    from fengshen_tpu_torch.ops.kernels.flash_attention import cuda_flash_fwd
    _, lse = cuda_flash_fwd(*args[:3], seg, kv_seg, causal)
    f32 = [a.float() for a in args]
    ref_out, ref_lse = torch_flash_forward(*f32[:3], seg, kv_seg, causal)
    ref_grads = torch_flash_bwd(*f32, lse, attention_delta(out.detach(),
                                                            args[3]),
                                seg, kv_seg, causal)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for got, want, what in zip([out, *grads], [ref_out, *ref_grads],
                               ("out", "dq", "dk", "dv")):
        assert torch.isfinite(got.float()).all(), what
        assert _worst_ratio(got, want, rtol) <= 1.0, what


@pytest.mark.gpu
def test_cuda_lse_and_row_with_no_valid_key(cuda_device):
    """The forward's lse against the plain log-sum-exp, and a row with no
    valid key: the uniform average, lse -1e30, zero dQ, dV += dO / Sk."""
    _, q, k, v, g, _ = _case("causal", seq=70, head_dim=64, seed=9)
    q_ids = np.ones((2, 70), np.int32)
    q_ids[1, 3] = 7
    kv_ids = np.ones((2, 70), np.int32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (q, k, v, g)]
    qs, ks = (torch.from_numpy(x).to(cuda_device) for x in (q_ids, kv_ids))
    tq, tk, tv = (a.clone().requires_grad_(True) for a in args[:3])
    out = kernel_flash_attention(tq, tk, tv, qs, ks, False)
    grads = torch.autograd.grad(out, (tq, tk, tv), args[3])
    from fengshen_tpu_torch.ops.kernels.flash_attention import cuda_flash_fwd
    _, lse = cuda_flash_fwd(*args[:3], qs, ks, False)
    ref_out, ref_lse = torch_flash_forward(*args[:3], qs, ks, False)
    ref_grads = torch_flash_backward(*args, qs, ks, False)
    torch.cuda.synchronize()
    assert lse[1, :, 3].eq(-1e30).all()
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
