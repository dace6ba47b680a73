"""Kernel K3 (paged decode attention) of the port against the JAX package.

On the CPU the port's plain version ``torch_decode_attention`` is held
against ``xla_decode_attention`` and against the Pallas TPU kernel run in
interpret mode, over slot and paged pools, S in {1, 5}, MHA and GQA, with
a fully masked lane in every case. fp32, atol/rtol 2e-5: the Pallas
kernel reassociates the softmax across blocks (online softmax), which
moves fp32 results by a few 1e-7; the xla lowering is the same formula.

The CUDA kernel itself runs only on the card: ``test_cuda_kernel_matches_plain``
is marked ``gpu`` and skips without one. JAX is imported inside the CPU
tests, so the card's machine (which has no JAX) can run the gpu tests:
``python -m pytest --noconftest -m gpu tests/test_torch_decode_attention.py``.
"""

import numpy as np
import pytest
import torch

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
    """CPU tensors go to the plain version and count no launch; int8
    pools are not ported yet."""
    q, k, v, valid, table = _case("paged", 1, 4, 2, seed=7)
    tq, tk, tv, tvalid, ttable = _torch(q, k, v, valid, table)
    entry = get_entry("decode_attention")
    before = (entry.launches, entry.dense_calls)
    out = decode_attention(tq, tk, tv, tvalid, block_table=ttable)
    torch.testing.assert_close(
        out, torch_decode_attention(tq, tk, tv, tvalid, block_table=ttable),
        rtol=0, atol=0)
    assert (entry.launches, entry.dense_calls) == before
    with pytest.raises(NotImplementedError):
        decode_attention(tq, tk, tv, tvalid, k_scale=tk[..., 0],
                         v_scale=tv[..., 0])


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


def test_eligible_shapes_stop_only_at_the_device():
    q, k, v, valid, table = _case("paged", 5, 8, 1, seed=4, block_size=8)
    with pytest.raises(ValueError, match="CUDA device"):
        check_eligible(*_torch(q, k, v, valid, table))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, layout, s, dtype):
    """The CUDA kernel against the plain version on the card. fp32:
    atol 1e-4 (online softmax and fp32 sums in another order); bf16:
    atol 2e-2 (the plain version rounds the probabilities to bf16 before
    PV, and both round the output to bf16, ulp 2^-8 near 1)."""
    q, k, v, valid, table = _case(layout, s, 8, 2, seed=11, head_dim=128,
                                  block_size=64)
    args = [None if a is None else torch.from_numpy(a).to(cuda_device)
            for a in (q, k, v, valid, table)]
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
