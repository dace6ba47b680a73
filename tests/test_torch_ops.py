"""The port's leaf ops against the JAX package's, on the CPU.

Same numpy inputs through both; fp32 throughout. Tolerance atol/rtol
1e-5: both sides compute the same fp32 formula and may differ only in
reduction order and in the last bit of transcendental functions
(sqrt, cos/sin, exp), a few 1e-7 at these magnitudes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fengshen_tpu.ops.attention import dot_product_attention as jax_attention
from fengshen_tpu.ops.embedding import embed_lookup as jax_embed_lookup
from fengshen_tpu.ops.masks import causal_mask as jax_causal_mask
from fengshen_tpu.ops.norms import RMSNorm as JaxRMSNorm
from fengshen_tpu.ops.rotary import apply_rotary_pos_emb as jax_rotary
from fengshen_tpu.ops.rotary import rotary_cos_sin as jax_cos_sin
from fengshen_tpu_torch.ops.attention import dot_product_attention
from fengshen_tpu_torch.ops.embedding import embed_lookup
from fengshen_tpu_torch.ops.masks import causal_mask
from fengshen_tpu_torch.ops.norms import RMSNorm
from fengshen_tpu_torch.ops.rotary import apply_rotary_pos_emb, rotary_cos_sin

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread here (the suite runs in
    parallel workers) and restore the process setting afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 48).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(48)).astype(np.float32)
    ref = JaxRMSNorm(epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = RMSNorm(48, epsilon=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        out = norm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rotary_matches_jax(rotary_dim):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 6, 4, 16).astype(np.float32)
    k = rng.randn(2, 6, 2, 16).astype(np.float32)
    pos = np.stack([np.arange(6), np.array([0, 0, 0, 1, 2, 3])])
    cos, sin = rotary_cos_sin(torch.from_numpy(pos), 16, base=500.0)
    jcos, jsin = jax_cos_sin(jnp.asarray(pos), 16, base=500.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    tq, tk = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(pos),
                                  rotary_dim=rotary_dim, base=500.0)
    jq, jk = jax_rotary(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                        rotary_dim=rotary_dim, base=500.0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


@pytest.mark.parametrize("q_len,k_len", [(5, None), (3, 7), (1, 4)])
def test_causal_mask_matches_jax(q_len, k_len):
    np.testing.assert_array_equal(causal_mask(q_len, k_len).numpy(),
                                  np.asarray(jax_causal_mask(q_len, k_len)))


def test_dense_attention_with_bool_mask_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 5, 3, 8).astype(np.float32)
    k = rng.randn(2, 7, 3, 8).astype(np.float32)
    v = rng.randn(2, 7, 3, 8).astype(np.float32)
    mask = rng.rand(2, 1, 5, 7) > 0.3
    mask[1, 0, 2] = False        # a fully masked row: uniform average
    out = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                mask=torch.from_numpy(mask))
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_embed_lookup_matches_jax():
    rng = np.random.RandomState(3)
    table = rng.randn(11, 6).astype(np.float32)
    ids = np.array([[0, 3, 10, -1], [11, 5, 2, 40]])  # out of range -> 0
    out = embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    ref = jax_embed_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
