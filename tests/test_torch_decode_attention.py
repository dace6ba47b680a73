"""Kernel K3 (paged decode attention) of the port against the JAX package.

On the CPU the port's plain version ``torch_decode_attention`` is held
against ``xla_decode_attention`` and against the Pallas TPU kernel run in
interpret mode, over slot and paged pools, S in {1, 5}, MHA and GQA, with
a fully masked lane in every case. fp32, atol/rtol 2e-5: the Pallas
kernel reassociates the softmax across blocks (online softmax), which
moves fp32 results by a few 1e-7; the xla lowering is the same formula.
The int8 branch likewise (int8 pools with fp32 per-(token, head)
scales, dequantized through fp32 or bf16), after ``quantize_kv`` /
``dequantize_kv`` are held bitwise to the JAX package's.

The CUDA kernel itself runs only on the card: ``test_cuda_kernel_matches_plain``
is marked ``gpu`` and skips without one. JAX is imported inside the CPU
tests, so the card's machine (which has no JAX) can run the gpu tests:
``python -m pytest --noconftest -m gpu tests/test_torch_decode_attention.py``.
"""

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.ops.int8_matmul import dequantize_kv, quantize_kv
from fengshen_tpu_torch.ops.kernels import get_entry
from fengshen_tpu_torch.ops.kernels.decode_attention import (
    check_eligible, decode_attention, torch_decode_attention)

TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(layout, s, n_heads, kv_heads, seed, batch=3, head_dim=64,
          blocks_per_lane=2, block_size=BLOCK):
    """Operands of one decode call, as numpy: lane 0 full, lane 1 fully
    masked (a parked lane), lane 2 ragged with left padding."""
    rng = np.random.RandomState(seed)
    virt = blocks_per_lane * block_size
    q = rng.randn(batch, s, n_heads, head_dim).astype(np.float32)
    pos = np.arange(virt)
    valid = np.zeros((batch, s, virt), bool)
    for t in range(s):
        valid[0, t] = pos <= virt - s + t
        valid[2, t] = (pos <= virt - 11 - s + t) & (pos >= 3)
    table = None
    if layout == "paged":
        nb = batch * blocks_per_lane + 1              # + the null block
        shape = (nb, block_size, kv_heads, head_dim)
        ids = rng.permutation(np.arange(1, nb)).reshape(
            batch, blocks_per_lane).astype(np.int32)
        ids[1] = 0                                    # parked on null
        table = ids
    else:
        shape = (batch, virt, kv_heads, head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return q, k, v, valid, table


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _int8_pool(shape, seed):
    """An int8 pool and its fp32 per-(token, head) scales, as
    ``tests/test_pallas_kernels.py`` builds them."""
    rng = np.random.RandomState(seed)
    values = rng.randint(-127, 128, shape).astype(np.int8)
    scales = (rng.rand(*shape[:-1]) * 0.02 + 0.001).astype(np.float32)
    return values, scales


def _int8_case(layout, s, seed, batch=3, n_heads=4, kv_heads=2,
               head_dim=128, block_size=128, blocks_per_lane=2):
    """The int8 decode case of ``tests/test_pallas_kernels.py:140-157``
    (ragged fill, the last block partial; q * 0.3), with a parked lane
    (lane 1: no valid position, on the null block when paged)."""
    rng = np.random.RandomState(seed)
    virt = block_size * blocks_per_lane
    q = (rng.randn(batch, s, n_heads, head_dim) * 0.3).astype(np.float32)
    valid = np.broadcast_to(np.arange(virt) < virt - 37,
                            (batch, s, virt)).copy()
    valid[1] = False
    table = None
    if layout == "paged":
        nb = batch * blocks_per_lane + 1
        shape = (nb, block_size, kv_heads, head_dim)
        table = rng.permutation(np.arange(1, nb)).reshape(
            batch, blocks_per_lane).astype(np.int32)
        table[1] = 0
    else:
        shape = (batch, virt, kv_heads, head_dim)
    k, ks = _int8_pool(shape, seed + 1)
    v, vs = _int8_pool(shape, seed + 2)
    return q, k, v, valid, table, ks, vs


def test_quantize_kv_matches_jax_bitwise():
    """int8 values and scales bitwise equal to the JAX package's, over
    random vectors, an all-zero vector (scale 1e-8 / 127), vectors whose
    absmax lands on +-127 exactly and exact rounding ties (k + 0.5)."""
    import jax.numpy as jnp

    from fengshen_tpu.ops.int8_matmul import dequantize_kv as jax_deq
    from fengshen_tpu.ops.int8_matmul import quantize_kv as jax_quant
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 6, 3, 16) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = -x[0, 1, 1]
    x[1, 2, 0, 0] = 127.0                 # scale 1: every value its own
    x[1, 2, 0, 1:] = np.arange(15) - 7.5  # ties at .5
    x[1, 2, 1] = np.linspace(-254, 254, 16)   # scale 2: ties at odd ints
    for dtype in (np.float32, "bfloat16"):
        xj = jnp.asarray(x, dtype)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
        if dtype == "bfloat16":
            xt = xt.bfloat16()
        q, scale = quantize_kv(xt)
        jq, jscale = jax_quant(xj)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = dequantize_kv(q, scale, dt).float().numpy()
            want = np.asarray(jax_deq(jq, jscale, jdt).astype(jnp.float32))
            np.testing.assert_array_equal(got, want)
    assert (quantize_kv(torch.zeros(2, 8))[0] == 0).all()


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dequant", ["fp32", "bf16"])
def test_int8_plain_matches_xla_and_pallas_interpret(layout, s, dequant):
    """The int8 plain version against ``xla_decode_attention`` and the
    Pallas kernel in interpret mode (GQA 4 over 2, a parked lane).
    Dequantized through fp32: atol/rtol 2e-5 as above. Through bf16:
    the xla lowering's output is bf16 and so is the plain version's
    (bitwise to 1 bf16 ulp); the Pallas kernel keeps fp32 probabilities
    and output, so against it the bar is 1e-2 absolute (bf16 rounding
    of |out| <= 1)."""
    import jax.numpy as jnp

    from fengshen_tpu.ops.pallas.decode_attention import (
        pallas_decode_attention, xla_decode_attention)
    seed = 200 + 100 * (layout == "paged") + 10 * s
    q, k, v, valid, table, ks, vs = _int8_case(layout, s, seed)
    dt, jdt = {"fp32": (torch.float32, jnp.float32),
               "bf16": (torch.bfloat16, jnp.bfloat16)}[dequant]
    tq, tk, tv, tvalid, ttable, tks, tvs = _torch(q, k, v, valid, table, ks,
                                                  vs)
    out = torch_decode_attention(tq, tk, tv, tvalid, k_scale=tks,
                                 v_scale=tvs, block_table=ttable,
                                 dequant_dtype=dt)
    assert out.shape == tq.shape and torch.isfinite(out.float()).all()
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
               dequant_dtype=jdt)
    if table is not None:
        jkw["block_table"] = jnp.asarray(table)
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    ref = np.asarray(xla_decode_attention(*args, **jkw).astype(jnp.float32))
    pallas = np.asarray(pallas_decode_attention(
        *args, interpret=True, **jkw).astype(jnp.float32))
    got = out.float().numpy()
    if dequant == "fp32":
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
    else:
        np.testing.assert_allclose(got, ref, atol=2 ** -8, rtol=2 ** -8)
        np.testing.assert_allclose(got, pallas, atol=1e-2, rtol=0)
    # the parked lane is the uniform average of its dequantized values
    lane = tv[1] if table is None else tv[0].repeat(2, 1, 1)
    lane_s = tvs[1] if table is None else tvs[0].repeat(2, 1)
    mean_v = dequantize_kv(lane, lane_s, dt).float().mean(0)
    np.testing.assert_allclose(got[1, 0], mean_v.repeat_interleave(
        2, dim=0).numpy(), atol=1e-2 if dequant == "bf16" else 2e-5)


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_plain_matches_xla_and_pallas_interpret(layout, s, heads):
    seed = 100 * (layout == "paged") + 10 * s + heads[1]
    q, k, v, valid, table = _case(layout, s, *heads, seed=seed)
    import jax.numpy as jnp

    from fengshen_tpu.ops.pallas.decode_attention import (
        pallas_decode_attention, xla_decode_attention)
    tq, tk, tv, tvalid, ttable = _torch(q, k, v, valid, table)
    out = torch_decode_attention(tq, tk, tv, tvalid, block_table=ttable)
    assert out.shape == tq.shape and torch.isfinite(out).all()

    jkw = {} if table is None else {"block_table": jnp.asarray(table)}
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    ref = xla_decode_attention(*args, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    pallas = pallas_decode_attention(*args, interpret=True,
                                     block_size=BLOCK, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    # the fully masked lane is the uniform average of its values
    lane_v = tv[1] if table is None else tv[0]        # null block
    if table is not None:
        lane_v = lane_v.repeat(2, 1, 1)
    rep = heads[0] // heads[1]
    mean_v = lane_v.mean(0).repeat_interleave(rep, dim=0)
    np.testing.assert_allclose(out[1, 0].numpy(), mean_v.numpy(), **TOL)


def test_seam_takes_the_plain_version_on_cpu():
    """CPU tensors go to the plain version and count no launch, int8
    pools with their scales included, which give the JAX package's
    ``xla_decode_attention`` with the same scales; only one of
    ``k_scale``/``v_scale`` raises."""
    q, k, v, valid, table = _case("paged", 1, 4, 2, seed=7)
    tq, tk, tv, tvalid, ttable = _torch(q, k, v, valid, table)
    entry = get_entry("decode_attention")
    before = (entry.launches, entry.dense_calls)
    out = decode_attention(tq, tk, tv, tvalid, block_table=ttable)
    torch.testing.assert_close(
        out, torch_decode_attention(tq, tk, tv, tvalid, block_table=ttable),
        rtol=0, atol=0)
    qk, ks = _int8_pool(k.shape, seed=8)
    qv, vs = _int8_pool(v.shape, seed=9)
    ti8 = _torch(qk, ks, qv, vs)
    kw = dict(k_scale=ti8[1], v_scale=ti8[3], block_table=ttable)
    out = decode_attention(tq, ti8[0], ti8[2], tvalid, **kw)
    torch.testing.assert_close(
        out, torch_decode_attention(tq, ti8[0], ti8[2], tvalid, **kw),
        rtol=0, atol=0)
    assert (entry.launches, entry.dense_calls) == before
    import jax.numpy as jnp

    from fengshen_tpu.ops.pallas.decode_attention import xla_decode_attention
    ref = xla_decode_attention(
        *(jnp.asarray(a) for a in (q, qk, qv, valid)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        block_table=jnp.asarray(table))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for scales in (dict(k_scale=ti8[1]), dict(v_scale=ti8[3])):
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            decode_attention(tq, ti8[0], ti8[2], tvalid, block_table=ttable,
                             **scales)


@pytest.mark.parametrize("change,match", [
    (dict(s=9), "query window"),
    (dict(head_dim=96), "head_dim"),
    (dict(block_size=12), "multiple of 8"),
    (dict(n_heads=8, kv_heads=1, s=9), "query window"),
])
def test_kernel_rules(change, match):
    """Shapes outside the kernel's rules raise (never a silent
    fallback); the rules are checked before the device."""
    kw = dict(layout="paged", s=1, n_heads=4, kv_heads=2, seed=3)
    kw.update(change)
    q, k, v, valid, table = _case(**kw)
    with pytest.raises(ValueError, match=match):
        check_eligible(*_torch(q, k, v, valid, table))


@pytest.mark.parametrize("change,match", [
    ("fp16_scales", "k_scale must be fp32"),
    ("scale_shape", "k_scale must be fp32"),
    ("bf16_pool", "int8 only"),
    ("fp16_dequant", "dequant_dtype"),
])
def test_int8_kernel_rules(change, match):
    """int8 pools need fp32 scales of the pool's leading shape, an int8
    pool and a bf16 or fp32 compute dtype; the rules are checked before
    the device."""
    q, k, v, valid, table, ks, vs = _int8_case("paged", 1, seed=3)
    tq, tk, tv, tvalid, ttable, tks, tvs = _torch(q, k, v, valid, table, ks,
                                                  vs)
    kw = dict(k_scale=tks, v_scale=tvs, dequant_dtype=torch.bfloat16)
    pool_k = tk
    if change == "fp16_scales":
        kw["k_scale"] = tks.half()
    elif change == "scale_shape":
        kw["k_scale"] = tks[:, :-1]
    elif change == "bf16_pool":
        pool_k = tk.bfloat16()
    else:
        kw["dequant_dtype"] = torch.float16
    with pytest.raises(ValueError, match=match):
        check_eligible(tq, pool_k, tv, tvalid, ttable, **kw)
    kw = dict(k_scale=tks, v_scale=tvs, dequant_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        check_eligible(tq.bfloat16(), tk, tv, tvalid, ttable, **kw)


def test_eligible_shapes_stop_only_at_the_device():
    q, k, v, valid, table = _case("paged", 5, 8, 1, seed=4, block_size=8)
    with pytest.raises(ValueError, match="CUDA device"):
        check_eligible(*_torch(q, k, v, valid, table))


@pytest.mark.parametrize("pairs", [1, 6, 320])
@pytest.mark.parametrize("lane_len", [8, 64, 1000, 2048, 40000])
def test_split_plan_covers_the_lane_once(lane_len, pairs):
    """The kernel's split-K plan (host code): the splits' token ranges
    cover every position of the lane exactly once, in order, each on a
    tile boundary, none empty and none longer than MAX_SPLIT_TILES
    tiles; a call with many pairs gets fewer splits than one with few.
    1000 and 40000 are not multiples of any split's length."""
    from fengshen_tpu_torch.ops.kernels.decode_attention import (
        MAX_SPLIT_TILES, TILE_TOKENS, split_plan)
    splits, per = split_plan(lane_len, pairs)
    span = per * TILE_TOKENS      # split i walks [i * span, (i + 1) * span)
    ranges = [(i * span, min((i + 1) * span, lane_len))
              for i in range(splits)]
    assert splits >= 1 and 1 <= per <= MAX_SPLIT_TILES
    covered = np.concatenate([np.arange(a, b) for a, b in ranges])
    np.testing.assert_array_equal(covered, np.arange(lane_len))
    for a, b in ranges:
        assert a % TILE_TOKENS == 0 and 0 < b - a <= per * TILE_TOKENS
    assert splits * per * TILE_TOKENS >= lane_len
    assert split_plan(lane_len, 10 * pairs)[0] <= splits


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: shapes of the split-K kernel held on the card (``base`` is the
#: original case). With 3 lanes the plan gives each (lane, KV head) pair
#: one split per 64-token tile, so a long lane is walked by many splits:
#: ``last_split`` puts lane 0's only valid positions in its last split,
#: ``dead_row`` does too and leaves lane 0's first query row no valid
#: position (its uniform mean needs the V of tiles whose K is skipped),
#: ``parked`` keeps lane 1 parked over all of them (its uniform mean
#: spans every split), ``block8/40/64`` page the lane in blocks of 8, 40
#: (split boundaries inside a block) and 64, and ``gqa`` is H 64 over
#: KVH 8 (S 5 becomes S 8: 64 query rows per KV head)
CARD_CASES = {
    "base": dict(blocks_per_lane=2, block_size=64),
    "last_split": dict(blocks_per_lane=32, block_size=64),
    "dead_row": dict(blocks_per_lane=32, block_size=64),
    "parked": dict(blocks_per_lane=32, block_size=64),
    "block8": dict(blocks_per_lane=40, block_size=8),
    "block40": dict(blocks_per_lane=9, block_size=40),
    "block64": dict(blocks_per_lane=12, block_size=64),
    "gqa": dict(blocks_per_lane=4, block_size=64, n_heads=64, kv_heads=8),
}


def _only_in_last_split(valid):
    """Lane 0 keeps only positions in its last 40 (causal per row)."""
    virt, s = valid.shape[2], valid.shape[1]
    pos = np.arange(virt)
    for t in range(s):
        valid[0, t] = (pos >= virt - 40) & (pos <= virt - s + t)
    return valid


def _card_args(case, layout, s, device, int8=False):
    """Operands of ``case`` on the card: q, k, v, valid, table (and the
    int8 scales)."""
    kw = dict(CARD_CASES[case])
    heads = dict(n_heads=kw.pop("n_heads", 8), kv_heads=kw.pop("kv_heads", 2))
    if case == "gqa" and s == 5:
        s = 8
    if int8:
        arrays = _int8_case(layout, s, seed=21, **heads, **kw)
    else:
        arrays = _case(layout, s, seed=11, head_dim=128, **heads, **kw)
    if case in ("last_split", "dead_row"):
        _only_in_last_split(arrays[3])
    if case == "dead_row":
        arrays[3][0, 0] = False
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, case, layout, s, dtype):
    """The CUDA kernel against the plain version on the card. fp32:
    atol 1e-4 (online softmax and fp32 sums in another order); bf16:
    atol 2e-2 (the plain version rounds the probabilities to bf16 before
    PV, and both round the output to bf16, ulp 2^-8 near 1)."""
    args = _card_args(case, layout, s, cuda_device)
    tq, tk, tv = (a.to(dtype) for a in args[:3])
    entry = get_entry("decode_attention")
    before = entry.launches
    out = decode_attention(tq, tk, tv, args[3], block_table=args[4])
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    ref = torch_decode_attention(tq, tk, tv, args[3], block_table=args[4])
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["base", "last_split", "dead_row", "gqa"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_kernel_matches_plain(cuda_device, case, layout, s, dtype):
    """The int8 branch against the int8 plain version run in fp32 on the
    same int8 inputs (dequantized through q's dtype): the base case at an
    odd lane length (paged: 3 blocks of 24) and GQA 6 over 2, a long
    lane whose valid positions lie in its last split, and H 64 over KVH
    8. Each element within 1e-4 (fp32) or 2e-2 (bf16 output; the kernel
    keeps fp32 probabilities) of the plain output, and the parked lane
    finite."""
    if case == "base":
        arrays = _int8_case(layout, s, seed=21, n_heads=6, kv_heads=2,
                            block_size=24, blocks_per_lane=3)
        args = [None if a is None else torch.from_numpy(a).to(cuda_device)
                for a in arrays]
    else:
        args = _card_args(case, layout, s, cuda_device, int8=True)
    tq = args[0].to(dtype)
    kw = dict(k_scale=args[5], v_scale=args[6], block_table=args[4],
              dequant_dtype=dtype)
    entry = get_entry("decode_attention")
    before = entry.launches
    out = decode_attention(tq, args[1], args[2], args[3], **kw)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    ref = torch_decode_attention(tq.float(), args[1], args[2], args[3],
                                 **kw).float()
    assert torch.isfinite(out.float()).all()
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cuda_kernel_is_bitwise_reproducible(cuda_device, pool, layout):
    """Two calls on the same inputs give bitwise-equal outputs: the
    splits' partials combine in a fixed order, and each call leaves the
    split counters at 0 for the next (a long lane, many splits)."""
    from fengshen_tpu_torch.ops.kernels.decode_attention import split_plan
    int8 = pool == "int8"
    args = _card_args("parked", layout, 5, cuda_device, int8=int8)
    dtype = torch.float32 if pool == "fp32" else torch.bfloat16
    q = args[0].to(dtype)
    if int8:
        kw = dict(k_scale=args[5], v_scale=args[6],
                  dequant_dtype=torch.bfloat16)
        k, v = args[1], args[2]
    else:
        kw = {}
        k, v = args[1].to(dtype), args[2].to(dtype)
    lane_len = args[3].shape[-1]
    assert split_plan(lane_len, q.shape[0] * k.shape[2])[0] > 1
    outs = [decode_attention(q, k, v, args[3], block_table=args[4], **kw)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
