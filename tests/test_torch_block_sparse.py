"""Kernel K4 (block-sparse attention) of the port against the JAX package.

On the CPU:

- the port's block layouts (BigBird, Longformer, fixed) equal the JAX
  package's for several seeds and sizes;
- the plain K4 (``torch_bs_fwd`` / ``torch_bs_bwd`` through the seam's
  ``torch.autograd.Function``) against ``block_sparse_attention(...,
  interpret=True)``, output and ``jax.vjp`` gradients, on the shapes of
  ``tests/test_block_sparse.py`` (S 32, block 8, head_dim 8): BigBird,
  Longformer, fixed, a query block with no present key block, Sq != Sk.
  fp32: atol 1e-5 (sums over at most 32 keys in another order move fp32
  results by ~1e-7). bf16 inputs: both round out, dq, dk and dv to bf16
  from fp32 sums, so they may differ by one bf16 ulp: 2^-7 relative
  plus 2^-9 absolute;
- ``dot_product_attention(impl="sparse")`` on CPU tensors takes the
  dense path with the layout expanded into a mask, as the JAX package
  does off the TPU, and equals its result (an empty row included:
  there, the uniform mean of V), counting one dense call;
- the kernels' rules raise before the device.

The CUDA kernels run only on the card: the ``gpu`` tests hold each of
them to its plain version run in fp32 on the same inputs, at small and
odd shapes; they import no JAX, so the card's machine runs them with
``python -m pytest --noconftest -m gpu tests/test_torch_block_sparse.py``.
"""

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.ops import masks
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.kernels import get_entry
from fengshen_tpu_torch.ops.kernels.block_sparse_attention import (
    attention_delta, block_sparse_attention, check_eligible, cuda_bs_bwd_dkv,
    cuda_bs_bwd_dq, cuda_bs_fwd, torch_block_sparse_attention, torch_bs_bwd,
    torch_bs_fwd)

SEQ, BLOCK, HEAD_DIM = 32, 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layouts():
    """name -> numpy block layout over (SEQ / BLOCK, SEQ / BLOCK)."""
    n = SEQ // BLOCK
    out = {
        "bigbird": masks.bigbird_block_layout(SEQ, BLOCK, 1, 1, 3, seed=1),
        "longformer": masks.longformer_block_layout(SEQ, BLOCK, 3, (0,)),
        "fixed": masks.fixed_block_layout(SEQ, BLOCK, 2, 1, causal=True),
    }
    empty = masks.longformer_block_layout(SEQ, BLOCK, 3, (0,))
    empty[n - 2] = False                      # a query block with nothing
    empty[:, n - 1] = False                   # and a key block nobody reads
    out["empty_row"] = empty
    return out


def _qkv(q_len, k_len, seed, heads=2, head_dim=HEAD_DIM, batch=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(batch, q_len, heads, head_dim).astype(np.float32)
    k = rng.randn(batch, k_len, heads, head_dim).astype(np.float32)
    v = rng.randn(batch, k_len, heads, head_dim).astype(np.float32)
    g = rng.randn(batch, q_len, heads, head_dim).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("seq,block", [(32, 8), (256, 16)])
def test_layouts_match_jax(seed, seq, block):
    from fengshen_tpu.ops import masks as jax_masks
    for name, kw in (
            ("bigbird_block_layout", dict(num_random_blocks=2,
                                          num_global_blocks=1,
                                          num_window_blocks=3, seed=seed)),
            ("bigbird_block_layout", dict(num_random_blocks=1,
                                          num_global_blocks=2,
                                          num_window_blocks=5, seed=seed,
                                          causal=True)),
            ("longformer_block_layout", dict(num_window_blocks=3 + 2 * seed,
                                             global_block_indices=(0, 2))),
            ("longformer_block_layout", dict(num_window_blocks=3,
                                             causal=True)),
            ("fixed_block_layout", dict(num_local_blocks=2 + seed,
                                        num_global_blocks=1)),
            ("fixed_block_layout", dict(num_local_blocks=4,
                                        num_global_blocks=2,
                                        causal=False))):
        got = getattr(masks, name)(seq, block, **kw)
        want = getattr(jax_masks, name)(seq, block, **kw)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw}")


def _jax_vjp(q, k, v, g, layout, block, dtype):
    import jax
    import jax.numpy as jnp

    from fengshen_tpu.ops.pallas.block_sparse_attention import (
        block_sparse_attention as jax_bs)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jax_bs(q, k, v, layout, block,
                                              interpret=True), *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(q, k, v, g, layout, block, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    out = block_sparse_attention(tq, tk, tv, layout, block)
    out.backward(torch.from_numpy(g).to(dtype))
    return [t.detach().float().numpy() for t in
            (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("name", ["bigbird", "longformer", "fixed",
                                  "empty_row"])
def test_plain_matches_pallas_interpret(name):
    layout = _layouts()[name]
    q, k, v, g = _qkv(SEQ, SEQ, seed=len(name))
    got = _port(q, k, v, g, layout, BLOCK, torch.float32)
    want = _jax_vjp(q, k, v, g, layout, BLOCK, np.float32)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=what)
    if name == "empty_row":
        rows = slice(SEQ - 2 * BLOCK, SEQ - BLOCK)
        np.testing.assert_array_equal(got[0][:, rows], 0.0)
        np.testing.assert_array_equal(got[1][:, rows], 0.0)
        np.testing.assert_array_equal(got[2][:, SEQ - BLOCK:], 0.0)


def test_plain_matches_pallas_interpret_sq_ne_sk():
    layout = np.random.RandomState(4).rand(24 // BLOCK, 40 // BLOCK) < 0.4
    layout[1] = False                         # an empty query block
    q, k, v, g = _qkv(24, 40, seed=3)
    got = _port(q, k, v, g, layout, BLOCK, torch.float32)
    want = _jax_vjp(q, k, v, g, layout, BLOCK, np.float32)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=what)


def test_plain_matches_pallas_interpret_bf16():
    import jax.numpy as jnp
    layout = _layouts()["bigbird"]
    q, k, v, g = _qkv(SEQ, SEQ, seed=11)
    got = _port(q, k, v, g, layout, BLOCK, torch.bfloat16)
    want = _jax_vjp(q, k, v, g, layout, BLOCK, jnp.bfloat16)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2 ** -9, rtol=2 ** -7,
                                   err_msg=what)


def test_plain_forward_lse_and_empty_rows():
    """The plain forward's lse is the log-sum-exp of the present scores,
    ~-1e30 on an empty row; ``torch_block_sparse_attention`` is its
    output."""
    layout = _layouts()["empty_row"]
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(SEQ, SEQ, seed=2))
    out, lse = torch_bs_fwd(q, k, v, layout, BLOCK)
    torch.testing.assert_close(
        torch_block_sparse_attention(q, k, v, layout, BLOCK), out,
        rtol=0, atol=0)
    dense = torch.from_numpy(np.kron(layout, np.ones((BLOCK, BLOCK), bool)))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HEAD_DIM)
    want = torch.logsumexp(scores.masked_fill(~dense, -np.inf), -1)
    live = dense.any(-1)
    torch.testing.assert_close(lse[..., live], want[..., live], atol=1e-5,
                               rtol=1e-6)
    assert (lse[..., ~live] <= -1e29).all()


def test_sparse_impl_on_cpu_is_the_dense_fallback():
    """On CPU tensors (and so wherever the JAX package cannot run its
    kernel) ``impl="sparse"`` expands the layout into a mask: the JAX
    package's result, an empty row's uniform mean of V included; a mask
    or segment ids combine with it as in the reference."""
    import jax.numpy as jnp

    from fengshen_tpu.ops.attention import \
        dot_product_attention as jax_attention
    layout = _layouts()["empty_row"]
    q, k, v, _ = _qkv(SEQ, SEQ, seed=5)
    seg = (np.arange(SEQ)[None] >= 12).astype(np.int32)
    entry = get_entry("block_sparse_attention_fwd")
    for kw in ({}, {"segment_ids": seg}):
        before = (entry.dense_calls, entry.launches)
        got = dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), impl="sparse",
            sparse_layout=layout, sparse_block_size=BLOCK,
            **{n: torch.from_numpy(a) for n, a in kw.items()})
        assert (entry.dense_calls, entry.launches) == (before[0] + 1,
                                                       before[1])
        want = jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             impl="sparse", sparse_layout=layout,
                             sparse_block_size=BLOCK,
                             **{n: jnp.asarray(a) for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    rows = slice(SEQ - 2 * BLOCK, SEQ - BLOCK)
    np.testing.assert_allclose(got.numpy()[:, rows],
                               np.asarray(want)[:, rows], atol=1e-5)


def test_dense_dropout_keeps_the_expected_share():
    """Dropout on the dense path zeroes about ``rate`` of the weights and
    rescales the rest, from the caller's generator (deterministic per
    seed); ``deterministic=True`` ignores it."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(SEQ, SEQ, seed=6))
    v = torch.ones_like(v)
    plain = dot_product_attention(q, k, v)
    outs = [dot_product_attention(
        q, k, v, dropout_rng=torch.Generator().manual_seed(3),
        dropout_rate=0.5, deterministic=False) for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    # with v = 1 the output is the row's kept weight mass, mean ~1
    assert abs(outs[0].mean().item() - 1.0) < 0.1
    assert not torch.allclose(outs[0], plain)
    torch.testing.assert_close(
        dot_product_attention(q, k, v, dropout_rate=0.5), plain,
        rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (dict(head_dim=96), "head_dim"),
    (dict(block=32), "multiple of 64"),
    (dict(q_len=192), "multiples of the block"),
    (dict(layout_shape=(1, 2)), "layout"),
    (dict(dtype=torch.float16), "bf16 or fp32"),
])
def test_kernel_rules(change, match):
    """Shapes outside the kernels' rules raise (never a silent
    fallback); the rules are checked before the device."""
    head_dim = change.get("head_dim", 64)
    block = change.get("block", 128)
    q_len = change.get("q_len", 256)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(1, q_len, 2, head_dim, dtype=dtype)
    k = torch.zeros(1, 256, 2, head_dim, dtype=dtype)
    shape = change.get("layout_shape", (q_len // block, 256 // block))
    with pytest.raises(ValueError, match=match):
        check_eligible(q, k, k, np.ones(shape, bool), block)
    with pytest.raises(ValueError, match="CUDA device"):
        check_eligible(torch.zeros(1, 256, 2, 64), torch.zeros(1, 256, 2, 64),
                       torch.zeros(1, 256, 2, 64), np.ones((2, 2), bool), 128)


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("seq,block,n_global,seed", [
    (8192, 128, 1, 0), (8192, 128, 2, 3), (1024, 64, 1, 1), (2304, 192, 1, 2),
])
def test_heavy_first_order(seq, block, n_global, seed, axis):
    """The kernels' grid order (host code): on a BigBird layout the
    query blocks (rows) or key blocks (columns) heaviest first, expanded
    to 64-row tiles as the grid walks them: a permutation of the tiles,
    non-increasing in present blocks, the global blocks first."""
    from fengshen_tpu_torch.ops.kernels.block_sparse_attention import (
        TILE, heavy_first)
    layout = masks.bigbird_block_layout(seq, block, 1, n_global, 3,
                                        seed=seed)
    lay = layout if axis == "rows" else layout.T
    per = block // TILE
    order = heavy_first(lay)
    # grid row y takes tile y % per of block order[y // per]
    tiles = (order[:, None].astype(np.int64) * per +
             np.arange(per)[None]).reshape(-1)
    np.testing.assert_array_equal(np.sort(tiles), np.arange(len(lay) * per))
    counts = lay.sum(1)[tiles // per]
    assert (np.diff(counts) <= 0).all()
    assert counts[0] == lay.shape[1] and counts[-1] < counts[0]
    np.testing.assert_array_equal(np.sort(order[:n_global]),
                                  np.arange(n_global))


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_case(q_len, k_len, heads, head_dim, block, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    def rnd(s):
        return torch.randn(2, s, heads, head_dim, generator=gen,
                           device=device).to(dtype)
    rng = np.random.RandomState(seed)
    layout = rng.rand(q_len // block, k_len // block) < 0.35
    layout[0, -1] = True                  # the first row starts late
    layout[0, :-1] = False
    layout[-1] = False                    # an empty query block
    layout[:, 1] = False                  # a key block nobody reads
    return rnd(q_len), rnd(k_len), rnd(k_len), rnd(q_len), layout


def _close(got, want, what, dtype):
    """bf16 outputs: within one bf16 ulp of the fp32 plain version plus
    1e-3 of the tensor's rms; fp32: 1e-4 of the rms."""
    want = want.float()
    rms = want.pow(2).mean().sqrt().item()
    if dtype == torch.bfloat16:
        atol, rtol = 1e-3 * rms + 1e-6, 2 ** -7
    else:
        atol, rtol = 1e-4 * rms + 1e-6, 1e-4
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("q_len,k_len,heads,head_dim,block", [
    (256, 256, 3, 64, 64), (384, 640, 2, 128, 128), (512, 256, 5, 128, 64),
    (576, 576, 2, 64, 192), (384, 768, 3, 128, 192),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, q_len, k_len, heads, head_dim,
                                  block, dtype):
    """Each kernel against its plain version in fp32 on the same inputs
    (the backward kernels' on the forward kernel's lse and delta), on a
    random layout whose first row starts late, with an empty query block
    and an unread key block."""
    q, k, v, g, layout = _card_case(q_len, k_len, heads, head_dim, block,
                                    dtype, seed=q_len + heads, device=cuda_device)
    out, lse = cuda_bs_fwd(q, k, v, layout, block)
    delta = attention_delta(out, g)
    dk, dv = cuda_bs_bwd_dkv(q, k, v, g, lse, delta, layout, block)
    dq = cuda_bs_bwd_dq(q, k, v, g, lse, delta, layout, block)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, g)]
    ref_out, ref_lse = torch_bs_fwd(*f32[:3], layout, block)
    ref_dq, ref_dk, ref_dv = torch_bs_bwd(*f32, lse, delta, layout, block)
    for what, got, want in (("out", out, ref_out), ("dq", dq, ref_dq),
                            ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert torch.isfinite(got.float()).all(), what
        _close(got, want, what, dtype)
    live = torch.from_numpy(np.repeat(layout.any(1), block)).to(cuda_device)
    torch.testing.assert_close(lse[..., live], ref_lse[..., live],
                               atol=1e-3, rtol=0)
    assert (lse[..., ~live] <= -1e29).all()
    assert (out[:, -block:] == 0).all() and (dk[:, block:2 * block] == 0).all()


@pytest.mark.gpu
def test_sparse_impl_runs_the_kernels_on_the_card(cuda_device):
    """``dot_product_attention(impl="sparse")`` and autograd on CUDA
    tensors: one launch of each kernel, no dense call, and the plain
    version's output and gradients."""
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    q, k, v, g, layout = _card_case(256, 256, 2, 128, 128, torch.float32,
                                    seed=9, device=cuda_device)
    layout[0, 0] = True
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    reset_launch_counts()
    out = dot_product_attention(qg, kg, vg, impl="sparse",
                                sparse_layout=layout, sparse_block_size=128)
    out.backward(g)
    torch.cuda.synchronize()
    counts = [(get_entry(n).launches, get_entry(n).dense_calls) for n in (
        "block_sparse_attention_fwd", "block_sparse_attention_bwd_dkv",
        "block_sparse_attention_bwd_dq")]
    assert counts == [(1, 0)] * 3
    ref_out, lse = torch_bs_fwd(q, k, v, layout, 128)
    ref = torch_bs_bwd(q, k, v, g, lse, attention_delta(ref_out, g), layout,
                       128)
    for what, got, want in (("out", out, ref_out), ("dq", qg.grad, ref[0]),
                            ("dk", kg.grad, ref[1]), ("dv", vg.grad, ref[2])):
        _close(got.detach(), want, what, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_dtype_runs_its_design(cuda_device, dtype):
    """bf16 inputs launch only the tensor-core kernels, fp32 inputs only
    the fp32 FMA kernels, one launch each per call."""
    from fengshen_tpu_torch.ops.kernels import reset_launch_counts
    from fengshen_tpu_torch.ops.kernels.block_sparse_attention import VARIANT
    q, k, v, g, layout = _card_case(256, 256, 2, 64, 128, dtype, seed=5,
                                    device=cuda_device)
    reset_launch_counts()
    out, lse = cuda_bs_fwd(q, k, v, layout, 128)
    delta = attention_delta(out, g)
    cuda_bs_bwd_dkv(q, k, v, g, lse, delta, layout, 128)
    cuda_bs_bwd_dq(q, k, v, g, lse, delta, layout, 128)
    torch.cuda.synchronize()
    for name in ("block_sparse_attention_fwd",
                 "block_sparse_attention_bwd_dkv",
                 "block_sparse_attention_bwd_dq"):
        assert get_entry(name).variants == {VARIANT[dtype]: 1}, name
