"""The port's LLaMA against the JAX package's, on the CPU.

The JAX model's flax params (scan_layers and unrolled layouts) go
through ``params_from_jax`` into the port; both run the same left-padded
batch. fp32 logits, atol/rtol 1e-4: two layers of the same fp32 math
differ by reduction order only (~1e-6 here); a wrong op moves logits by
far more than 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fengshen_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from fengshen_tpu.models.llama import LlamaForCausalLM as JaxLlama
from fengshen_tpu_torch.models.llama import (KVCache, LlamaConfig,
                                             LlamaForCausalLM,
                                             params_from_jax)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    base = dict(dtype="float32", param_dtype="float32",
                num_key_value_heads=2, initializer_range=0.2)
    base.update(kw)
    return (JaxLlamaConfig.small_test_config(**base),
            LlamaConfig.small_test_config(**base))


def _batch():
    """Left-padded ids/mask and mask-cumsum positions."""
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 250, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, :5] = 0
    mask[2, :9] = 0
    ids[mask == 0] = 0
    pos = np.clip(mask.cumsum(-1) - 1, 0, None)
    return ids, mask, pos


@pytest.fixture(scope="module")
def jax_logits():
    """JAX params and logits per layout, computed once."""
    ids, mask, pos = _batch()
    out = {}
    for scan in (False, True):
        jcfg, _ = _configs(scan_layers=scan)
        model = JaxLlama(jcfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                     jnp.asarray(ids))["params"]
        logits = jax.jit(model.apply)({"params": params}, jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      position_ids=jnp.asarray(pos))
        out[scan] = (jax.tree_util.tree_map(np.asarray, params),
                     np.asarray(logits))
    return out


def _port(params, scan):
    _, cfg = _configs(scan_layers=scan)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))   # strict
    return model


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_params_from_jax_logits_parity(jax_logits, scan):
    params, ref = jax_logits[scan]
    model = _port(params, scan)
    ids, mask, pos = (torch.from_numpy(a).long() for a in _batch())
    with torch.no_grad():
        logits = model(ids, attention_mask=mask, position_ids=pos)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


def test_params_from_jax_maps_every_weight(jax_logits):
    """Both layouts give the same state dict, with flax [in, out]
    kernels transposed to [out, in]."""
    _, cfg = _configs()
    unrolled = params_from_jax(jax_logits[False][0], cfg)
    _, scfg = _configs(scan_layers=True)
    scanned = params_from_jax(jax_logits[True][0], scfg)
    assert unrolled.keys() == scanned.keys()
    layer0 = jax_logits[False][0]["model"]["layers_0"]
    np.testing.assert_array_equal(
        unrolled["model.layers.0.self_attn.k_proj.weight"].numpy(),
        layer0["self_attn"]["k_proj"]["kernel"].T)
    assert unrolled["model.layers.0.self_attn.k_proj.weight"].shape == \
        (cfg.num_key_value_heads * cfg.head_dim, cfg.hidden_size)


def test_cached_prefill_matches_cacheless_forward(jax_logits):
    """The decode path (cache given: writes, then the decode seam over
    the whole lane) gives the cacheless logits at every real position
    (a pad query row is fully masked, so it averages the whole lane in
    one path and the prompt in the other, as in the reference)."""
    model = _port(jax_logits[False][0], False)
    ids, mask, pos = (torch.from_numpy(a).long() for a in _batch())
    cache = KVCache.zeros(model.config, 3, 32, "cpu", torch.float32)
    with torch.no_grad():
        cached = model(ids, attention_mask=mask, position_ids=pos,
                       cache=cache)
        plain = model(ids, attention_mask=mask, position_ids=pos)
    assert cache.index == 12
    real = mask.bool()
    torch.testing.assert_close(cached[real], plain[real], **TOL)


def test_flash_impl_and_int8_head_not_ported(jax_logits):
    """``attention_impl="flash"`` runs (kernel K1's dispatch, which takes
    its plain version on the CPU) and gives the JAX package's flash
    logits on the left-padded batch, pad rows included (pads are segment
    0 and attend to pads in both); impls not yet ported and the int8 LM
    head raise."""
    params = jax_logits[False][0]
    jcfg, cfg = _configs(attention_impl="flash")
    ids, mask, pos = _batch()
    ref = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask),
                               position_ids=jnp.asarray(pos))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    with torch.no_grad():
        logits = model(*(torch.from_numpy(a).long() for a in (ids, mask)),
                       position_ids=torch.from_numpy(pos).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    _, cfg = _configs(attention_impl="ring")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        LlamaForCausalLM(cfg, device="cpu")(torch.zeros((1, 4),
                                                        dtype=torch.long))
    _, cfg = _configs(int8_lm_head=True)
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(cfg, device="cpu")


def test_gradient_checkpointing_matches_plain_backward():
    """Per-layer recompute (remat policy "nothing") gives the gradients
    of the plain backward exactly; other remat policies raise."""
    _, cfg = _configs(attention_impl="flash")
    _, remat_cfg = _configs(attention_impl="flash",
                            gradient_checkpointing=True)
    ids, mask, pos = (torch.from_numpy(a).long() for a in _batch())
    grads = []
    for c in (cfg, remat_cfg):
        model = LlamaForCausalLM(c, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        model(ids, attention_mask=mask, position_ids=pos).square().mean() \
            .backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)
    _, bad = _configs(gradient_checkpointing=True, remat_policy="dots_no_batch")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        LlamaForCausalLM(bad, device="cpu")


def test_weights_made_from_a_seed():
    """Random weights come from the caller's generator: same seed, same
    weights; param_dtype is the storage dtype."""
    _, cfg = _configs(param_dtype="bfloat16")
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    wa = a.model.layers[1].mlp.up_proj.weight
    assert wa.dtype == torch.bfloat16
    torch.testing.assert_close(wa, b.model.layers[1].mlp.up_proj.weight,
                               rtol=0, atol=0)
    assert a.model.norm.weight.dtype == torch.float32
    assert float(wa.detach().float().std()) == pytest.approx(0.2, rel=0.1)
