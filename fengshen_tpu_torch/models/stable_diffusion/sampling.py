"""Text-to-image sampling for Taiyi Stable Diffusion: the port of
``fengshen_tpu/models/stable_diffusion/sampling.py`` (:21-69).

A deterministic ancestral walk over a subsampled DDPM schedule with
classifier-free guidance (``eps_u + g (eps - eps_u)`` when
unconditional ids are given and ``g > 1``), then the VAE decode of
``latents / SCALING_FACTOR``, clipped to [0, 1]. The initial latents
are drawn by :func:`initial_latents` (or given), so a test can feed
the JAX package's draw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl import (
    SCALING_FACTOR)
from fengshen_tpu_torch.models.stable_diffusion.scheduler import \
    DDPMScheduler


def inference_timesteps(num_train_timesteps: int, num_steps: int
                        ) -> np.ndarray:
    """The int32 ``jnp.linspace(T - 1, 0, n)`` of the JAX sampler,
    computed as XLA computes it on the CPU, in fp32 (``start * (1 - i *
    (1 / (n - 1)))``, truncated): at n = 4 it gives 999, 665, 332, 0,
    where a float64 linspace gives 666 and 333. Equal to JAX's for every
    n up to 500 (the tests check them); at n = 1000 XLA's vectorised
    division parts from it."""
    start = np.float32(num_train_timesteps - 1)
    if num_steps == 1:
        return np.asarray([start], np.float32).astype(np.int32)
    div = num_steps - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1) /
                                               np.float32(div))
    out = start * (np.float32(1) - step)
    return np.concatenate([out, np.zeros(1, np.float32)]).astype(np.int32)


def initial_latents(shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """The sampler's standard normal start ``[B, C, H, W]``, drawn on
    the host from ``generator`` and moved to ``device``."""
    return torch.randn(shape, generator=generator).to(device)


@torch.no_grad()
def text_to_image(model, input_ids: torch.Tensor,
                  uncond_ids: Optional[torch.Tensor] = None,
                  image_size: int = 512, num_steps: int = 50,
                  guidance_scale: float = 7.5,
                  generator: Optional[torch.Generator] = None,
                  scheduler: Optional[DDPMScheduler] = None,
                  latent_guidance_fn=None,
                  latents: Optional[torch.Tensor] = None,
                  step_callback=None,
                  timesteps: Optional[np.ndarray] = None) -> torch.Tensor:
    """``input_ids [B, S]`` (and unconditional ids for guidance) ->
    images ``[B, H, W, 3]`` in [0, 1], on the model's device.

    ``generator`` draws the initial latents (default seed 0) unless
    ``latents`` are given. ``timesteps`` replaces the schedule
    :func:`inference_timesteps` gives for ``num_steps`` (the image
    pipeline walks its own). ``latent_guidance_fn(latents) -> latents``
    runs after every denoise step (the hook CLIP-guided sampling plugs
    into); ``step_callback(i)`` is called after step ``i`` (timing)."""
    scheduler = scheduler or DDPMScheduler()
    device = next(model.parameters()).device
    input_ids = torch.as_tensor(input_ids, device=device)
    batch = input_ids.shape[0]
    text = model.encode_text(input_ids)
    uncond = None
    if uncond_ids is not None and guidance_scale > 1.0:
        uncond = model.encode_text(torch.as_tensor(uncond_ids,
                                                   device=device))
    if latents is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        latents = initial_latents(
            (batch,) + tuple(model.vae_config.latent_shape(image_size)),
            generator, device)
    latents = latents.to(device)
    if timesteps is None:
        timesteps = inference_timesteps(scheduler.num_train_timesteps,
                                        num_steps)
    prev = list(timesteps[1:]) + [-1]
    for i, (t, t_prev) in enumerate(zip(timesteps, prev)):
        tb = torch.full((batch,), int(t), dtype=torch.int32, device=device)
        eps = model.denoise(latents, tb, text)
        if uncond is not None:
            eps_u = model.denoise(latents, tb, uncond)
            eps = eps_u + guidance_scale * (eps - eps_u)
        latents = scheduler.step(eps, int(t), latents,
                                 prev_timestep=int(t_prev))
        if latent_guidance_fn is not None:
            latents = latent_guidance_fn(latents)
        if step_callback is not None:
            step_callback(i)
    pixels = model.vae.decode(latents / SCALING_FACTOR)
    return torch.clamp(pixels / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


def init_sampling_params(model, generator: torch.Generator):
    """The counterpart of the JAX helper that inits a tree covering the
    decoder too: the port's module holds every tower's weights from
    construction, so this draws them all from ``generator`` and returns
    the module."""
    model.init_weights(generator)
    return model
