"""The port's Taiyi Stable Diffusion against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port; weights are carried by ``convert.params_from_jax`` at test
size (a 2-layer text tower of width 32; the compact towers'
``small_test_config``; the SD-1.x towers' ``small_test_config``) in fp32
with dropout off. The port draws its own random numbers, so where the
JAX function draws (initial latents, timesteps, noise, the posterior's
noise) the test computes the JAX draws and feeds them to the port.

- ``scheduler``: betas, ``add_noise``, ``get_velocity`` and ``step``
  (eps and v, a subsampled schedule, ``prev_timestep`` -1) within 1e-7.
- The compact and SD-1.x UNet and VAE forwards, ``TaiyiStableDiffusion``
  (``__call__``, ``denoise``, ``decode_image``), ``diffusion_loss`` (eps
  and v) and ``text_to_image`` (with and without guidance) within 1e-5
  relative L2; the timestep embeddings and the 2x nearest resize.
- One training step: the UNet's loss, gradients and AdamW update
  against ``jax.grad`` of the JAX module and optax at weight decay 0;
  at 0.1 the port's frozen towers are bitwise unchanged while the JAX
  package's "frozen" text kernels decay.
- ``convert``: the original-format remap, a diffusers-layout directory
  (safetensors and bin) read by both packages, the old VAE attention
  names, the export back, configs from ``config.json``, the text
  encoder, the CLI.
- ``data/clip_dataloader``: the collators bitwise (NCHW), decoded
  ``pixels`` samples, the refusal without Pillow.
- ``finetune.main`` fitted and resumed on the CPU; ``demo.main`` against
  the JAX demo; the entry points' default device.

Hygiene: torch runs on one intra-op thread (restored after); the port's
Trainer installs a process-wide SIGTERM handler, put back after each
test.
"""

import argparse
import csv
import signal
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fengshen_tpu_torch.models import bert as port_bert
from fengshen_tpu_torch.models import stable_diffusion as port_sd
from fengshen_tpu_torch.models.stable_diffusion import convert as port_cv
from fengshen_tpu_torch.models.stable_diffusion import sampling as port_smp
from fengshen_tpu_torch.trainer import trainer as port_trainer

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _sigterm_restored():
    handler = signal.getsignal(signal.SIGTERM)
    state = dict(port_trainer._SIGTERM_STATE)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_trainer._SIGTERM_STATE.clear()
    port_trainer._SIGTERM_STATE.update(state)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


TEXT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, dtype="float32",
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
IMAGE = 16
SEQ = 8


def tower_configs(pkg, kind):
    """(text, vae, unet) configs of ``pkg`` ("jax" or "port")."""
    if pkg == "jax":
        from fengshen_tpu.models.bert import BertConfig
        from fengshen_tpu.models.stable_diffusion import (SDUNetConfig,
                                                          SDVAEConfig)
        from fengshen_tpu.models.stable_diffusion.autoencoder_kl import \
            VAEConfig
        from fengshen_tpu.models.stable_diffusion.unet import UNetConfig
    else:
        from fengshen_tpu_torch.models.bert import BertConfig
        from fengshen_tpu_torch.models.stable_diffusion import (
            SDUNetConfig, SDVAEConfig, UNetConfig, VAEConfig)
    if kind == "faithful":
        return (BertConfig(**TEXT), SDVAEConfig.small_test_config(),
                SDUNetConfig.small_test_config())
    return (BertConfig(**TEXT), VAEConfig.small_test_config(),
            UNetConfig.small_test_config(cross_attention_dim=32))


_PAIRS: dict = {}


def pair(kind):
    """``(jax module, jax params, port module)`` on the same weights."""
    if kind not in _PAIRS:
        import jax

        from fengshen_tpu.models.stable_diffusion import \
            TaiyiStableDiffusion as JaxSD
        from fengshen_tpu.models.stable_diffusion.sampling import \
            init_sampling_params
        jm = JaxSD(*tower_configs("jax", kind))
        params = init_sampling_params(jm, jax.random.PRNGKey(0), IMAGE,
                                      SEQ)
        params = jax.tree_util.tree_map(np.asarray, params)
        pm = port_sd.TaiyiStableDiffusion(*tower_configs("port", kind),
                                          device="cpu", init=False)
        pm.load_state_dict(port_cv.params_from_jax(params), strict=True)
        _PAIRS[kind] = (jm, params, pm)
    return _PAIRS[kind]


def batch_arrays(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 128, (batch, SEQ)).astype(np.int32)
    mask = np.ones((batch, SEQ), np.int32)
    mask[1, 5:] = 0
    ids[1, 5:] = 0
    pixels = rng.uniform(-1, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32)
    return ids, mask, pixels


# -- scheduler ------------------------------------------------------------

@pytest.mark.parametrize("schedule,prediction", [
    ("scaled_linear", "epsilon"), ("scaled_linear", "v_prediction"),
    ("linear", "epsilon"), ("linear", "v_prediction")])
def test_scheduler_matches_jax(schedule, prediction):
    from fengshen_tpu.models.stable_diffusion import DDPMScheduler
    js = DDPMScheduler(beta_schedule=schedule, prediction_type=prediction)
    ps = port_sd.DDPMScheduler(beta_schedule=schedule,
                               prediction_type=prediction)
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 5, 5).astype(np.float32)
    eps = rng.randn(3, 4, 5, 5).astype(np.float32)
    t = np.array([0, 517, 999], np.int32)
    for name in ("add_noise", "get_velocity"):
        want = np.asarray(getattr(js, name)(x, eps, t))
        got = getattr(ps, name)(torch.tensor(x), torch.tensor(eps),
                                torch.tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    for t, prev in ((999, 665), (332, 0), (0, -1), (500, None)):
        want = np.asarray(js.step(eps, t, x, prev_timestep=prev))
        got = ps.step(torch.tensor(eps), t, torch.tensor(x),
                      prev_timestep=prev).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        port_sd.DDPMScheduler(beta_schedule="cosine")


def test_timestep_embeddings_match_jax():
    """Within 1e-5 relative L2: ``exp`` of the frequencies may part by an
    ulp between XLA and torch, which moves ``sin(999 f)`` by ~6e-5."""
    from fengshen_tpu.models.stable_diffusion.unet import \
        timestep_embedding
    from fengshen_tpu.models.stable_diffusion.unet_sd import \
        sd_timestep_embedding
    from fengshen_tpu_torch.models.stable_diffusion import unet as pu
    from fengshen_tpu_torch.models.stable_diffusion import unet_sd as pus
    t = np.array([0, 1, 250, 999], np.int32)
    for flip, shift in ((True, 0), (False, 1)):
        want = np.asarray(sd_timestep_embedding(t, 320, flip, shift))
        got = pus.sd_timestep_embedding(torch.tensor(t), 320, flip, shift)
        assert rel_l2(got.numpy(), want) < REL
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    got = pu.timestep_embedding(torch.tensor(t), 32).numpy()
    want = np.asarray(timestep_embedding(t, 32))
    assert rel_l2(got, want) < REL
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_nearest_upsample_matches_jax_resize():
    """``F.interpolate(mode="nearest")`` at 2x is ``jax.image.resize``'s
    nearest, bitwise; a non-2x size takes the half-pixel centres."""
    import jax

    from fengshen_tpu_torch.models.stable_diffusion.unet_sd import \
        upsample_nearest
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 10, 14, 3), "nearest"))
    np.testing.assert_array_equal(nhwc(upsample_nearest(nchw(x))), want)
    want = np.asarray(jax.image.resize(x, (2, 9, 13, 3), "nearest"))
    np.testing.assert_array_equal(
        nhwc(upsample_nearest(nchw(x), (9, 13))), want)


# -- towers ---------------------------------------------------------------

@pytest.mark.parametrize("tower", ["sd_unet", "sd_vae", "unet", "vae"])
def test_tower_forward_matches_jax(tower):
    """Each tower alone, on flax's own random init carried over."""
    import jax

    from fengshen_tpu.models.stable_diffusion import (autoencoder_kl,
                                                      unet, unet_sd,
                                                      vae_sd)
    from fengshen_tpu_torch.models.stable_diffusion import (
        autoencoder_kl as pak, unet as pun, unet_sd as pus, vae_sd as pvs)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ctx = rng.randn(2, 5, 32).astype(np.float32)
    px = rng.randn(2, 16, 16, 3).astype(np.float32)
    if tower in ("sd_unet", "unet"):
        jmod, pcls = ((unet_sd.SDUNet2DConditionModel(
            unet_sd.SDUNetConfig.small_test_config()),
            lambda: pus.SDUNet2DConditionModel(
                pus.SDUNetConfig.small_test_config(), device="cpu"))
            if tower == "sd_unet" else
            (unet.UNet2DConditionModel(unet.UNetConfig.small_test_config()),
             lambda: pun.UNet2DConditionModel(
                 pun.UNetConfig.small_test_config(), device="cpu")))
        params = jmod.init(jax.random.PRNGKey(1), x, t, ctx)["params"]
        want = [np.asarray(jmod.apply({"params": params}, x, t, ctx))]
        pm = pcls()
        pm.load_state_dict(port_cv.params_from_jax(params), strict=True)
        got = [nhwc(pm(nchw(x), torch.tensor(t), torch.tensor(ctx)))]
    else:
        jmod, pcls = ((vae_sd.SDAutoencoderKL(
            vae_sd.SDVAEConfig.small_test_config()),
            lambda: pvs.SDAutoencoderKL(
                pvs.SDVAEConfig.small_test_config(), device="cpu"))
            if tower == "sd_vae" else
            (autoencoder_kl.AutoencoderKL(
                autoencoder_kl.VAEConfig.small_test_config()),
             lambda: pak.AutoencoderKL(pak.VAEConfig.small_test_config(),
                                       device="cpu")))
        params = jmod.init(jax.random.PRNGKey(2), px)["params"]
        post = jax.random.normal(jax.random.PRNGKey(5), (2, 8, 8, 4))
        recon, mean, logvar = jmod.apply({"params": params}, px,
                                         jax.random.PRNGKey(5))
        want = [np.asarray(a) for a in (recon, mean, logvar)]
        pm = pcls()
        pm.load_state_dict(port_cv.params_from_jax(params), strict=True)
        got = [nhwc(a) for a in pm(nchw(px), nchw(post))]
        assert tuple(pm.config.latent_shape(16)) == (4, 8, 8)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_l2(g, w) < REL, rel_l2(g, w)


@pytest.mark.parametrize("kind", ["compact", "faithful"])
def test_taiyi_call_matches_jax(kind):
    """``__call__`` with the JAX posterior draw fed in, then ``denoise``
    and ``decode_image`` on its outputs."""
    import jax

    jm, params, pm = pair(kind)
    ids, mask, pixels = batch_arrays()
    t = np.array([17, 801], np.int32)
    noise = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    pred, latents = jm.apply({"params": params}, ids, pixels, t, noise,
                             attention_mask=mask, rng=key)
    post = jax.random.normal(key, (2, 8, 8, 4))
    ppred, plat = pm(torch.tensor(ids), nchw(pixels), torch.tensor(t),
                     nchw(noise), attention_mask=torch.tensor(mask),
                     posterior_noise=nchw(post))
    assert rel_l2(nhwc(plat), latents) < REL
    assert rel_l2(nhwc(ppred), pred) < REL
    decoded = jm.apply({"params": params}, np.asarray(latents),
                       method=type(jm).decode_image)
    with torch.no_grad():
        got = pm.decode_image(nchw(latents))
    assert rel_l2(nhwc(got), decoded) < REL


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_diffusion_loss_matches_jax(prediction):
    from fengshen_tpu.models.stable_diffusion import diffusion_loss
    rng = np.random.RandomState(6)
    pred, lat, noise = (rng.randn(2, 8, 8, 4).astype(np.float32)
                        for _ in range(3))
    t = np.array([5, 950], np.int32)
    want = float(diffusion_loss(pred, lat, noise, t,
                                prediction_type=prediction))
    got = float(port_sd.diffusion_loss(nchw(pred), nchw(lat), nchw(noise),
                                       torch.tensor(t),
                                       prediction_type=prediction))
    assert abs(got - want) <= REL * abs(want)


# -- sampling -------------------------------------------------------------

def test_inference_timesteps_match_jnp_linspace():
    import jax.numpy as jnp
    for n in list(range(1, 201)) + [250, 500]:
        want = np.asarray(jnp.linspace(999, 0, n).astype(jnp.int32))
        np.testing.assert_array_equal(port_smp.inference_timesteps(1000, n),
                                      want)


@pytest.mark.parametrize("guided", [True, False])
def test_text_to_image_matches_jax(guided):
    """``text_to_image`` under the JAX sampler's initial draw; guided
    runs classifier-free guidance at 7.5."""
    import jax

    from fengshen_tpu.models.stable_diffusion.sampling import \
        text_to_image as jax_t2i
    jm, params, pm = pair("faithful")
    ids, _, _ = batch_arrays(7)
    uncond = np.zeros_like(ids) if guided else None
    want = np.asarray(jax_t2i(jm, params, ids, uncond_ids=uncond,
                              image_size=IMAGE, num_steps=4,
                              guidance_scale=7.5,
                              rng=jax.random.PRNGKey(3)))
    latents = jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 4))
    steps = []
    got = port_smp.text_to_image(
        pm, torch.tensor(ids),
        uncond_ids=None if uncond is None else torch.tensor(uncond),
        image_size=IMAGE, num_steps=4, guidance_scale=7.5,
        latents=nchw(latents), step_callback=steps.append)
    assert steps == [0, 1, 2, 3]
    assert got.shape == want.shape == (2, IMAGE, IMAGE, 3)
    assert rel_l2(got.numpy(), want) < REL
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


# -- one training step -----------------------------------------------------

#: the step tests' learning rate. AdamW's first step is lr * sign(g)
#: almost everywhere, so an element whose gradient is 0 up to rounding
#: moves by +-lr in either package; at 1e-4 such an element stays within
#: the 1e-5 bar on the updated weights (~0.05 in size).
STEP_LR = 1e-4


def _module_args(pkg, tmp_path, weight_decay):
    """The fine-tune parser of ``pkg`` over the same flags."""
    text_dir = tmp_path / "text"
    port_bert.BertConfig(**TEXT).save_pretrained(str(text_dir))
    argv = ["--model_path", str(text_dir), "--learning_rate", str(STEP_LR),
            "--weight_decay", str(weight_decay), "--scheduler_type",
            "direct", "--image_size", str(IMAGE)]
    if pkg == "port":
        from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
            import finetune
        return finetune.parser().parse_args(argv + ["--device", "cpu"])
    from fengshen_tpu.data import UniversalDataModule
    from fengshen_tpu.examples.finetune_taiyi_stable_diffusion.finetune \
        import TaiyiSDModule
    from fengshen_tpu.models.model_utils import add_module_args
    from fengshen_tpu.trainer import add_trainer_args
    from fengshen_tpu.utils import UniversalCheckpoint
    p = argparse.ArgumentParser()
    for add in (add_module_args, add_trainer_args,
                UniversalDataModule.add_data_specific_args,
                UniversalCheckpoint.add_argparse_args,
                TaiyiSDModule.add_module_specific_args):
        p = add(p)
    return p.parse_args(argv)


def _one_step(tmp_path, weight_decay):
    """``(jax params before, jax params after, port module before, port
    module after, losses)`` of one AdamW step on the same batch and the
    JAX draws."""
    import jax
    import optax

    from fengshen_tpu.examples.finetune_taiyi_stable_diffusion.finetune \
        import TaiyiSDModule as JaxModule
    from fengshen_tpu.models.model_utils import \
        configure_optimizers as jax_opt
    from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
        import finetune

    _, params, _ = pair("faithful")
    jcfg, pcfg = tower_configs("jax", "faithful"), \
        tower_configs("port", "faithful")
    jargs = _module_args("jax", tmp_path, weight_decay)
    pargs = _module_args("port", tmp_path, weight_decay)
    jmod = JaxModule(jargs, *jcfg)
    ids, mask, pixels = batch_arrays(8)
    batch = {"input_ids": ids, "attention_mask": mask,
             "pixel_values": pixels}
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        return jmod.training_loss(p, batch, key)[0]

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    tx, _ = jax_opt(jargs, 10, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    jnew = jax.tree_util.tree_map(np.asarray,
                                  optax.apply_updates(params, updates))
    # the JAX module's draws, in its order
    rng_t, rng_n, rng_vae, _ = jax.random.split(key, 4)
    t = jax.random.randint(rng_t, (2,), 0, 1000)
    noise = jax.random.normal(rng_n, (2, 8, 8, 4))
    post = jax.random.normal(rng_vae, (2, 8, 8, 4))

    module = finetune.TaiyiSDModule(pargs, *pcfg, device="cpu")
    model = module.init_params(torch.Generator().manual_seed(0))
    model.load_state_dict(port_cv.params_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    module.draw = lambda b, shape, gen, dev: (
        torch.tensor(np.asarray(t)), nchw(noise), nchw(post))
    optimizer, _ = module.configure_optimizers(10, model)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tbatch["pixel_values"] = nchw(pixels)
    module.set_dropout_generator(torch.Generator().manual_seed(1))
    loss, _ = module.training_loss(tbatch)
    loss.backward()
    optimizer.step()
    grads = port_cv.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads))
    return params, jnew, before, model, float(jloss), loss.item(), grads


def test_training_step_unet_update_matches_jax(tmp_path):
    """The loss, every UNet gradient (1e-4 relative L2, plus 1e-7 of the
    largest gradient's norm for one that is zero up to rounding) and the
    UNet after AdamW's step: each kernel within 1e-5 relative L2, and the
    whole UNet. A bias or norm parameter, 0 or 1 at init, is not held
    alone: where its gradient is 0 up to rounding, AdamW's first step,
    lr * sign(g), moves it by +-lr in either package."""
    params, jnew, before, model, jloss, ploss, jgrads = _one_step(
        tmp_path, 0.0)
    assert abs(ploss - jloss) <= REL * abs(jloss)
    want = port_cv.params_from_jax(jnew)
    after = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert set(grads) == {n for n in want if n.startswith("unet.")}
    floor = 1e-7 * max(float(g.norm()) for g in jgrads.values())
    for name, g in grads.items():
        err = float((g - jgrads[name]).norm())
        assert err <= 1e-4 * float(jgrads[name].norm()) + floor, name
    moved = 0
    for name in grads:
        if after[name].dim() >= 2:
            assert rel_l2(after[name].numpy(), want[name].numpy()) < REL, \
                name
        moved += int(not torch.equal(after[name], before[name]))
    assert moved == len(grads)
    flat = [(after[n].flatten(), want[n].flatten()) for n in grads]
    assert rel_l2(torch.cat([a for a, _ in flat]).numpy(),
                  torch.cat([w for _, w in flat]).numpy()) < REL


def test_frozen_towers_take_no_decay(tmp_path):
    """At --weight_decay 0.1 the port's text tower and VAE are bitwise
    unchanged after a step (no moments, no decay); the JAX module's
    stop_gradient leaves its text kernels to AdamW's decoupled decay."""
    params, jnew, before, model, _, _, _ = _one_step(tmp_path, 0.1)
    after = model.state_dict()
    for name, value in after.items():
        if name.startswith(("text_encoder.", "vae.")):
            assert torch.equal(value, before[name]), name
    assert any(not torch.equal(after[n], before[n]) for n in after
               if n.startswith("unet."))
    jk = params["text_encoder"]["layer_0"]["query"]["kernel"]
    jk_new = jnew["text_encoder"]["layer_0"]["query"]["kernel"]
    assert not np.array_equal(jk, jk_new)
    np.testing.assert_allclose(jk_new, jk * (1 - STEP_LR * 0.1), rtol=1e-6)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(n.startswith("unet.") for n in trainable)


# -- convert --------------------------------------------------------------

def _diffusers_state(kind):
    """A diffusers-named state dict: the port tower's own (its names
    are diffusers')."""
    _, _, pm = pair("faithful")
    tower = pm.unet if kind == "unet" else pm.vae
    return {k: v.clone() for k, v in tower.state_dict().items()}


def _old_attention_names(state):
    """The VAE mid attention as 2022-era diffusers names it
    (query/key/value/proj_attn)."""
    renames = {"to_q": "query", "to_k": "key", "to_v": "value",
               "to_out.0": "proj_attn"}
    old = {}
    for k, v in state.items():
        for new, name in renames.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{name}.")
        old[k] = v
    return old


def test_diffusers_to_original_matches_jax():
    from fengshen_tpu.models.stable_diffusion import convert as jax_cv
    unet = _diffusers_state("unet")
    text = {"embeddings.word_embeddings.weight": torch.ones(3, 2)}
    for vae in (_diffusers_state("vae"),
                _old_attention_names(_diffusers_state("vae"))):
        want = jax_cv.diffusers_to_original(unet, vae, text)
        got = port_cv.diffusers_to_original(unet, vae, text)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    # the old names are the original format's 1x1 convs
    assert got["first_stage_model.decoder.mid.attn_1.q.weight"].dim() == 4


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_diffusers_dir_round_trip(tmp_path, fmt):
    """A tiny diffusers-layout pipeline directory read by both packages
    gives the same towers; the export writes the state back."""
    import json

    from fengshen_tpu.models.stable_diffusion import convert as jax_cv
    from fengshen_tpu_torch.utils.convert_common import write_safetensors
    cfgs = {"unet": dict(block_out_channels=[32, 64], layers_per_block=1,
                         cross_attention_dim=32, attention_head_dim=2,
                         norm_num_groups=8, sample_size=8,
                         down_block_types=["CrossAttnDownBlock2D",
                                           "DownBlock2D"],
                         up_block_types=["UpBlock2D",
                                         "CrossAttnUpBlock2D"],
                         _class_name="UNet2DConditionModel"),
            "vae": dict(block_out_channels=[16, 32], layers_per_block=1,
                        norm_num_groups=4, latent_channels=4)}
    states = {}
    for tower, cfg in cfgs.items():
        d = tmp_path / tower
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        states[tower] = _diffusers_state(tower)
        if fmt == "safetensors":
            write_safetensors(str(d / "diffusion_pytorch_model.safetensors"),
                              states[tower])
        else:
            torch.save(states[tower], d / "diffusion_pytorch_model.bin")
    ucfg, ustate, vcfg, vstate = port_cv.load_diffusers_pipeline(
        str(tmp_path))
    jucfg, juparams, jvcfg, jvparams = jax_cv.load_diffusers_pipeline(
        str(tmp_path))
    assert ucfg == port_sd.SDUNetConfig.small_test_config()
    assert vcfg == port_sd.SDVAEConfig.small_test_config()
    for got, jparams in ((ustate, juparams), (vstate, jvparams)):
        want = port_cv.params_from_jax(jparams)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    back = port_cv.unet_params_to_diffusers(ustate, states["unet"])
    for k, v in states["unet"].items():
        assert torch.equal(back[k], v), k
    u, v, pipe = port_cv.resolve_towers(str(tmp_path))
    assert set(pipe) == {"unet", "vae"} and u == ucfg and v == vcfg


def test_old_vae_attention_names():
    """2022-era diffusers VAE checkpoints name the mid attention
    query/key/value/proj_attn: imported as the current names, and
    exported back under the template's."""
    state = _diffusers_state("vae")
    old = _old_attention_names(state)
    assert any("proj_attn" in k for k in old)
    got = port_cv.vae_to_params(old)
    assert set(got) == set(state)
    for k in state:
        assert torch.equal(got[k], state[k])
    back = port_cv.vae_params_to_diffusers(got, old)
    assert list(back) == list(old)


def test_configs_from_diffusers_json():
    from fengshen_tpu.models.stable_diffusion import convert as jax_cv
    unet = {"block_out_channels": [320, 640, 1280, 1280],
            "attention_head_dim": 8, "cross_attention_dim": 768,
            "_class_name": "UNet2DConditionModel", "dtype": "float16"}
    vae = {"block_out_channels": [128, 256, 512, 512],
           "latent_channels": 4, "sample_size": 512}
    pu, pv = (port_cv.sd_unet_config_from_diffusers(unet),
              port_cv.sd_vae_config_from_diffusers(vae))
    ju, jv = (jax_cv.sd_unet_config_from_diffusers(unet),
              jax_cv.sd_vae_config_from_diffusers(vae))
    import dataclasses
    assert dataclasses.asdict(pu) == dataclasses.asdict(ju)
    assert dataclasses.asdict(pv) == dataclasses.asdict(jv)
    assert pu == port_sd.SDUNetConfig() and pv == port_sd.SDVAEConfig()


def test_text_encoder_to_params_matches_jax():
    """An HF ``BertModel`` state dict (no ``bert.`` prefix) into the
    text tower, against the JAX converter's tree."""
    from fengshen_tpu.models.stable_diffusion import convert as jax_cv
    from fengshen_tpu.models.bert import BertConfig as JaxBert
    from fengshen_tpu_torch.models.bert import convert as bert_cv
    _, _, pm = pair("compact")
    port_state = {f"bert.{k}": v for k, v in
                  pm.text_encoder.state_dict().items()}
    hf = {k[len("bert."):]: v for k, v in bert_cv.params_to_torch_state(
        port_state, pm.text_config).items()}
    got = port_cv.text_encoder_to_params(hf, pm.text_config)
    want = port_cv.params_from_jax(
        {"text_encoder": jax_cv.text_encoder_to_params(
            hf, JaxBert(**TEXT))})
    assert set(got) == {k[len("text_encoder."):] for k in want}
    for k, v in got.items():
        torch.testing.assert_close(v, want[f"text_encoder.{k}"], rtol=0,
                                   atol=0)
    pm2 = port_sd.TaiyiStableDiffusion(*tower_configs("port", "compact"),
                                       device="cpu", init=False)
    pm2.text_encoder.load_state_dict(got, strict=True)


def test_resolve_towers_and_cli(tmp_path):
    u, v, none = port_cv.resolve_towers(faithful=True, small_test=True)
    assert none is None and u == port_sd.SDUNetConfig.small_test_config()
    u, v, _ = port_cv.resolve_towers()
    assert u == port_sd.UNetConfig() and v == port_sd.VAEConfig()
    for tower, name in (("unet", "diffusion_pytorch_model.bin"),
                        ("vae", "diffusion_pytorch_model.bin"),
                        ("text_encoder", "pytorch_model.bin")):
        (tmp_path / tower).mkdir()
        state = {"w.weight": torch.ones(2)} if tower == "text_encoder" \
            else _old_attention_names(_diffusers_state(tower))
        torch.save(state, tmp_path / tower / name)
    out = tmp_path / "model.ckpt"
    port_cv.main(["--model_path", str(tmp_path), "--checkpoint_path",
                  str(out), "--half"])
    ckpt = torch.load(out, weights_only=True)["state_dict"]
    assert ckpt["cond_stage_model.transformer.w.weight"].dtype == \
        torch.float16
    assert "model.diffusion_model.input_blocks.0.0.weight" in ckpt
    assert "first_stage_model.encoder.mid.attn_1.q.weight" in ckpt


# -- data -----------------------------------------------------------------

class CharTok:
    """The HF tokenizer call the collators make, one id per character;
    ``encode`` for the demo and the pipeline."""

    pad_token_id = 0

    def __call__(self, texts, padding=None, truncation=None,
                 max_length=None, return_tensors=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = self.encode(text)[:max_length]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def encode(self, text):
        return [3 + (ord(c) % 120) for c in text]


def _image_csv(tmp_path, n=3):
    from PIL import Image
    rng = np.random.RandomState(0)
    rows = []
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (40, 50, 3), np.uint8)).save(
            tmp_path / f"img_{i}.png")
        rows.append({"image": f"img_{i}.png", "caption": f"图片{i}号"})
    path = tmp_path / "data.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "caption"])
        w.writeheader()
        w.writerows(rows)
    return str(path)


def test_collators_match_jax(tmp_path):
    from fengshen_tpu.data import clip_dataloader as jax_cd
    from fengshen_tpu_torch.data import clip_dataloader as port_cd
    path = _image_csv(tmp_path)
    jds, pds = jax_cd.ImageTextCSVDataset(path), \
        port_cd.ImageTextCSVDataset(path)
    assert len(pds) == 3 and [pds[i] for i in range(3)] == \
        [jds[i] for i in range(3)]
    for name, kw in (("SDCollator", dict(image_size=16, max_length=8)),
                     ("CLIPCollator", dict(image_size=24, max_length=8))):
        want = getattr(jax_cd, name)(CharTok(), **kw)([jds[0], jds[2]])
        got = getattr(port_cd, name)(CharTok(), **kw)([pds[0], pds[2]])
        assert set(got) == set(want)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(
            got["pixel_values"], want["pixel_values"].transpose(0, 3, 1, 2))
        assert got["pixel_values"].dtype == np.float32


def test_collator_takes_decoded_pixels_and_needs_pillow(tmp_path,
                                                        monkeypatch):
    from fengshen_tpu_torch.data import clip_dataloader as port_cd
    from fengshen_tpu_torch.data.clip_dataloader import image_text
    path = _image_csv(tmp_path)
    ds = port_cd.ImageTextCSVDataset(path)
    img = port_cd.load_image(ds[1]["image_path"], 16)
    coll = port_cd.SDCollator(CharTok(), image_size=16, max_length=8)
    want = coll([ds[1]])
    got = coll([{"caption": ds[1]["caption"], "pixels": img}])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="expected"):
        coll([{"caption": "x", "pixels": img[:8]}])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        image_text.load_image(ds[0]["image_path"], 16)
    # decoded pixels need no Pillow
    coll([{"caption": "x", "pixels": img}])


# -- entry points -----------------------------------------------------------

def _fit_argv(tmp_path, steps, name="run"):
    text_dir = tmp_path / "text"
    port_bert.BertConfig(**TEXT).save_pretrained(str(text_dir))
    ck = tmp_path / f"{name}_ckpt"
    return ["--model_path", str(text_dir), "--image_size", str(IMAGE),
            "--max_length", str(SEQ), "--train_batchsize", "2",
            "--max_steps", str(steps), "--learning_rate", "1e-3",
            "--scheduler_type", "direct", "--log_every_n_steps", "1",
            "--default_root_dir", str(tmp_path / name),
            "--save_ckpt_path", str(ck), "--load_ckpt_path", str(ck),
            "--seed", "7", "--device", "cpu"]


def _pixel_samples(n=8):
    rng = np.random.RandomState(12)
    return [{"caption": f"第{i}张图", "pixels": rng.uniform(
        0, 1, (IMAGE, IMAGE, 3)).astype(np.float32)} for i in range(n)]


def test_finetune_main_fits_and_resumes(tmp_path):
    """``main`` on the SD-1.x test towers: three steps straight, and two
    steps then a resume for the third, which draws the same timesteps,
    noise and posterior noise and so takes the same loss."""
    from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
        import finetune

    def losses(trainer):
        return [e["loss"] for e in trainer.history if "loss" in e]

    towers = port_cv.resolve_towers(faithful=True, small_test=True)
    with mock.patch.object(port_cv, "resolve_towers",
                           lambda *a, **k: towers):
        full = finetune.main(_fit_argv(tmp_path, 3, "full") +
                             ["--faithful_towers"], tokenizer=CharTok(),
                             datasets={"train": _pixel_samples()})
        argv = _fit_argv(tmp_path, 2, "resumed") + ["--faithful_towers"]
        first = finetune.main(argv, tokenizer=CharTok(),
                              datasets={"train": _pixel_samples()})
        argv[argv.index("--max_steps") + 1] = "3"
        second = finetune.main(argv, tokenizer=CharTok(),
                               datasets={"train": _pixel_samples()})
    want = losses(full)
    assert len(want) == 3 and np.isfinite(want).all()
    assert losses(first) == want[:2]
    assert losses(second) == want[2:]
    model = second.state.model
    assert isinstance(model.unet, port_sd.SDUNet2DConditionModel)
    assert not any(p.requires_grad for p in model.vae.parameters())
    for a, b in zip(full.state.model.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_finetune_flags_match_jax():
    from fengshen_tpu.examples.finetune_taiyi_stable_diffusion.finetune \
        import TaiyiSDModule as JaxModule
    from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
        import finetune

    def flags(add):
        p = argparse.ArgumentParser()
        add(p)
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    assert flags(finetune.TaiyiSDModule.add_module_specific_args) == \
        flags(JaxModule.add_module_specific_args)


def test_demo_main_matches_jax(tmp_path):
    """Both demos on the same towers, prompt and initial draw."""
    import jax

    from fengshen_tpu.examples.stable_diffusion_chinese import \
        demo as jax_demo
    from fengshen_tpu_torch.examples.stable_diffusion_chinese import demo
    jm, params, pm = pair("compact")
    argv = ["--prompt", "一只橘猫", "--guidance_scale", "3.0", "--out",
            str(tmp_path / "port.png")]
    want = jax_demo.main(argv[:-1] + [str(tmp_path / "jax.png")], model=jm,
                         params=params, tokenizer=CharTok(),
                         image_size=IMAGE, num_steps=3)
    latents = jax.random.normal(jax.random.PRNGKey(0), (1, 8, 8, 4))
    with mock.patch.object(port_smp, "initial_latents",
                           lambda *a: nchw(latents)):
        got = demo.main(argv, model=pm, tokenizer=CharTok(),
                        image_size=IMAGE, num_steps=3)
    assert got.shape == want.shape == (1, IMAGE, IMAGE, 3)
    assert rel_l2(got, want) < REL
    assert (tmp_path / "port.png").exists()
    toy = demo.main(["--device", "cpu", "--out", str(tmp_path / "t.png")],
                    image_size=IMAGE, num_steps=2)
    assert toy.shape == (1, IMAGE, IMAGE, 3) and np.isfinite(toy).all()
    # the counterpart of JAX's init_sampling_params draws every tower
    a, b = (port_sd.TaiyiStableDiffusion(*tower_configs("port", "compact"),
                                         device="cpu", init=False)
            for _ in range(2))
    assert port_smp.init_sampling_params(
        a, torch.Generator().manual_seed(1)) is a
    port_smp.init_sampling_params(b, torch.Generator().manual_seed(1))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y) and torch.isfinite(x).all(), name


def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion \
        import finetune
    from fengshen_tpu_torch.examples.stable_diffusion_chinese import demo
    from fengshen_tpu_torch.pipelines.image_generation import Pipeline
    cfgs = tower_configs("port", "compact")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_sd.TaiyiStableDiffusion(*cfgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_sd.SDUNet2DConditionModel(port_sd.SDUNetConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(small_test=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main([])
    argv = _fit_argv(tmp_path, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.main(argv[:-2], tokenizer=CharTok(),
                      datasets={"train": _pixel_samples(2)})


def test_generate_docstring_names_what_is_unported():
    """The module docstring of ``utils/generate.py`` names the seq2seq
    decoders as ported and only the causal-LM helpers as unported."""
    from fengshen_tpu_torch.utils import generate
    doc = generate.__doc__
    assert "Seq2seq and" not in doc
    assert "sample_sequence_batch" in doc and "generate_with_prompts" in doc
    for name in ("seq2seq_generate", "seq2seq_beam_search"):
        assert callable(getattr(generate, name)) and name in doc
    for name in ("sample_sequence_batch", "generate_with_prompts"):
        assert not hasattr(generate, name)
