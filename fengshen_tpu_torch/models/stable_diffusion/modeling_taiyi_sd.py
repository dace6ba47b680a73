"""Taiyi Stable Diffusion: the text encoder, VAE and UNet in one module,
the port of ``fengshen_tpu/models/stable_diffusion/modeling_taiyi_sd.py``.

The training step (:112-144 of the reference's ``finetune.py``): VAE
encode -> x 0.18215 -> ``scheduler.add_noise`` -> the Chinese text
tower (the port's ``BertModel`` without a pooler) -> the UNet -> MSE
against the eps or v target (:func:`diffusion_loss`). The UNet and VAE
configs pick the towers: ``SDUNetConfig`` / ``SDVAEConfig`` build the
SD-1.x architecture that loads the released weights
(``convert.load_diffusers_pipeline``), ``UNetConfig`` / ``VAEConfig``
the compact ones.

The random draws come in as arguments: ``posterior_noise`` (the
standard normal draw that samples the VAE posterior) and the training
step's timesteps and noise are drawn by the caller (the fine-tune
module's ``draw``), so a test can feed the JAX package's draws through
everything below them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from fengshen_tpu_torch.device import resolve_device
from fengshen_tpu_torch.models.bert import BertConfig, BertModel
from fengshen_tpu_torch.models.layers import init_weights
from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl import (
    SCALING_FACTOR, AutoencoderKL)
from fengshen_tpu_torch.models.stable_diffusion.scheduler import \
    DDPMScheduler
from fengshen_tpu_torch.models.stable_diffusion.unet import \
    UNet2DConditionModel
from fengshen_tpu_torch.models.stable_diffusion.unet_sd import (
    SDUNet2DConditionModel, SDUNetConfig, init_tower)
from fengshen_tpu_torch.models.stable_diffusion.vae_sd import (
    SDAutoencoderKL, SDVAEConfig)


class TaiyiStableDiffusion(nn.Module):
    """``text_encoder`` + ``vae`` + ``unet``. ``device=None`` means
    ``cuda`` and raises without a card; with ``init`` the weights are
    drawn there from ``generator``: the text tower N(0,
    ``initializer_range``) as the port's BERT draws it, the towers LeCun
    normal as flax's defaults draw them."""

    def __init__(self, text_config: BertConfig, vae_config: Any,
                 unet_config: Any, device=None,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.text_config = text_config
        self.vae_config = vae_config
        self.unet_config = unet_config
        self.text_encoder = BertModel(text_config, add_pooling_layer=False,
                                      device="meta", init=False)
        vae_cls = SDAutoencoderKL if isinstance(vae_config, SDVAEConfig) \
            else AutoencoderKL
        unet_cls = SDUNet2DConditionModel if isinstance(
            unet_config, SDUNetConfig) else UNet2DConditionModel
        self.vae = vae_cls(vae_config, device="meta", init=False)
        self.unet = unet_cls(unet_config, device="meta", init=False)
        dev = resolve_device(device)
        self.to_empty(device=dev)
        if init and dev.type != "meta":
            self.init_weights(generator if generator is not None else
                              torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self.text_encoder, generator,
                     self.text_config.initializer_range)
        init_tower(self.vae, generator)
        init_tower(self.unet, generator)

    def encode_text(self, input_ids, attention_mask=None,
                    deterministic: bool = True,
                    dropout_rng: Optional[torch.Generator] = None):
        hidden, _ = self.text_encoder(input_ids, attention_mask,
                                      deterministic=deterministic,
                                      dropout_rng=dropout_rng)
        return hidden

    def encode_image(self, pixels: torch.Tensor,
                     posterior_noise: Optional[torch.Tensor] = None):
        """Scaled latents of ``pixels [B, 3, H, W]``: the posterior
        sampled with ``posterior_noise`` when given, else its mean."""
        mean, logvar = self.vae.encode(pixels)
        latent = mean if posterior_noise is None else \
            mean + torch.exp(0.5 * logvar) * posterior_noise
        return latent * SCALING_FACTOR

    def denoise(self, noisy_latents, timesteps, text_states):
        return self.unet(noisy_latents, timesteps, text_states)

    def decode_image(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> pixels in [-1, 1] (roughly)."""
        return self.vae.decode(latents / SCALING_FACTOR)

    def forward(self, input_ids, pixels, timesteps, noise,
                attention_mask=None, posterior_noise=None,
                deterministic: bool = True,
                dropout_rng: Optional[torch.Generator] = None,
                frozen_towers: bool = False):
        """``(pred, latents)``. ``frozen_towers`` runs the text tower and
        the VAE without autograd (their weights take no gradient)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and
                                    not frozen_towers):
            latents = self.encode_image(pixels, posterior_noise)
            text = self.encode_text(input_ids, attention_mask,
                                    deterministic, dropout_rng)
        noisy = DDPMScheduler().add_noise(latents, noise, timesteps)
        return self.denoise(noisy, timesteps, text), latents


def diffusion_loss(pred, latents, noise, timesteps,
                   scheduler: Optional[DDPMScheduler] = None,
                   prediction_type: str = "epsilon") -> torch.Tensor:
    """MSE against the eps or v target (reference ``finetune.py``
    :130-136), in fp32."""
    scheduler = scheduler or DDPMScheduler(prediction_type=prediction_type)
    if prediction_type == "v_prediction":
        target = scheduler.get_velocity(latents, noise, timesteps)
    else:
        target = noise
    return torch.mean(torch.square(pred.float() - target.float()))
