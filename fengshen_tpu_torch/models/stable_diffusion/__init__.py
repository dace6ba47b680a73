"""Taiyi Stable Diffusion in PyTorch: the port of
``fengshen_tpu/models/stable_diffusion/`` (NCHW towers; see each
module)."""

from fengshen_tpu_torch.models.stable_diffusion.scheduler import \
    DDPMScheduler
from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl import (
    SCALING_FACTOR, AutoencoderKL, VAEConfig)
from fengshen_tpu_torch.models.stable_diffusion.unet import (
    UNet2DConditionModel, UNetConfig)
from fengshen_tpu_torch.models.stable_diffusion.unet_sd import (
    SDUNet2DConditionModel, SDUNetConfig)
from fengshen_tpu_torch.models.stable_diffusion.vae_sd import (
    SDAutoencoderKL, SDVAEConfig)
from fengshen_tpu_torch.models.stable_diffusion.modeling_taiyi_sd import (
    TaiyiStableDiffusion, diffusion_loss)

__all__ = ["DDPMScheduler", "SCALING_FACTOR", "AutoencoderKL", "VAEConfig",
           "UNet2DConditionModel", "UNetConfig", "SDUNetConfig",
           "SDUNet2DConditionModel", "SDVAEConfig", "SDAutoencoderKL",
           "TaiyiStableDiffusion", "diffusion_loss"]
