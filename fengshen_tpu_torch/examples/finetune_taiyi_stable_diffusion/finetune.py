"""Taiyi Stable Diffusion fine-tuning (Chinese latent diffusion): the
port of ``fengshen_tpu/examples/finetune_taiyi_stable_diffusion/finetune.py``.

Caption + image pairs -> VAE latents (x 0.18215) -> noise and timesteps
-> the UNet's eps (or v) prediction, MSE (reference ``finetune.py``
:67-158). The text tower and the VAE are frozen with
``requires_grad_(False)`` unless ``--train_whole_model`` is set: the
optimizer then holds no moments for them and decays nothing of them,
and their forward runs without autograd. (The JAX module freezes with
``stop_gradient`` and hands the whole tree to AdamW, whose decoupled
decay still shrinks the "frozen" kernels every step.)

The timesteps, the noise and the posterior's noise of a step are drawn
by :meth:`TaiyiSDModule.draw` from the step's host generator, which the
Trainer seeds from ``(--seed, global step)``: a resumed run draws what
the uninterrupted run drew.

``main(argv, tokenizer=..., datasets=...)``: the tokenizer defaults to
``--model_path``'s (``models/auto.AutoTokenizer``), the data to
``--train_csv`` (images decoded with Pillow) or ``--train_file``;
``datasets={"train": [...]}`` may hold samples with decoded ``pixels``
instead (``data/clip_dataloader``), so the fit runs where neither
``transformers`` nor Pillow is installed. ``--model_path`` names the
text tower's BERT config; ``--faithful_towers`` builds the SD-1.x
UNet and VAE (random weights), ``--sd_pipeline_path`` the same with a
released diffusers pipeline's ``unet`` and ``vae`` weights.

Run (on the card; ``--device cpu`` for the CPU):
    python -m fengshen_tpu_torch.examples.finetune_taiyi_stable_diffusion.\\
finetune --model_path <text-tower-dir> --sd_pipeline_path <sd-dir> \\
        --train_csv pairs.csv --train_batchsize 8 --max_steps 1000 \\
        --learning_rate 1e-5 --weight_decay 0.1 \\
        --save_ckpt_path runs/ckpt --load_ckpt_path runs/ckpt
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from fengshen_tpu_torch.models.bert import BertConfig
from fengshen_tpu_torch.models.stable_diffusion import (DDPMScheduler,
                                                        TaiyiStableDiffusion,
                                                        diffusion_loss)
from fengshen_tpu_torch.models.stable_diffusion.autoencoder_kl import \
    VAEConfig
from fengshen_tpu_torch.models.stable_diffusion.unet import UNetConfig
from fengshen_tpu_torch.trainer.module import TrainModule


class TaiyiSDModule(TrainModule):
    """The reference's ``StableDiffusion`` module. The model is built on
    ``device`` without weights; :meth:`init_params` draws them, loads a
    released pipeline's towers and freezes."""

    def __init__(self, args, text_config: Optional[BertConfig] = None,
                 vae_config=None, unet_config=None, device=None):
        super().__init__(args)
        if text_config is None:
            if not getattr(args, "model_path", None):
                raise ValueError("TaiyiSDModule needs --model_path (the "
                                 "text tower's BERT config) or "
                                 "text_config")
            text_config = BertConfig.from_pretrained(args.model_path)
        self._pipeline_state = None
        if vae_config is None and unet_config is None and (
                getattr(args, "sd_pipeline_path", None) or
                getattr(args, "faithful_towers", False)):
            from fengshen_tpu_torch.models.stable_diffusion.convert import \
                resolve_towers
            unet_config, vae_config, self._pipeline_state = resolve_towers(
                getattr(args, "sd_pipeline_path", None),
                faithful=getattr(args, "faithful_towers", False))
        self.model = TaiyiStableDiffusion(
            text_config, vae_config or VAEConfig(),
            unet_config or UNetConfig(), device=device, init=False)
        self.config = text_config
        self.prediction_type = getattr(args, "prediction_type", "epsilon")
        self.scheduler = DDPMScheduler(prediction_type=self.prediction_type)

    @staticmethod
    def add_module_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("taiyi sd")
        parser.add_argument("--image_size", type=int, default=512)
        parser.add_argument("--max_length", type=int, default=77)
        parser.add_argument("--prediction_type", type=str,
                            default="epsilon",
                            choices=["epsilon", "v_prediction"])
        parser.add_argument("--train_whole_model", action="store_true",
                            default=False,
                            help="unfreeze the text encoder and the VAE "
                                 "(reference: finetune.py:91-100)")
        parser.add_argument("--train_csv", type=str, default=None)
        parser.add_argument("--image_root", type=str, default=None)
        parser.add_argument("--sd_pipeline_path", type=str, default=None,
                            help="released diffusers pipeline dir: the "
                                 "SD-1.x towers with its unet/vae weights")
        parser.add_argument("--faithful_towers", action="store_true",
                            default=False,
                            help="the SD-1.x towers (random weights) "
                                 "without a pipeline dir")
        return parent_parser

    @property
    def frozen_towers(self) -> bool:
        return not getattr(self.args, "train_whole_model", False)

    def init_params(self, generator: torch.Generator):
        """Every weight drawn from ``generator``, then a released
        pipeline's ``unet`` / ``vae`` loaded over them; the text tower
        and the VAE frozen unless ``--train_whole_model``."""
        model = self.model
        model.init_weights(generator)
        if self._pipeline_state is not None:
            for tower, state in self._pipeline_state.items():
                getattr(model, tower).load_state_dict(state, strict=True)
            # the host copy (~3.4 GB at SD scale) is not kept
            self._pipeline_state = None
        for tower in (model.text_encoder, model.vae):
            tower.requires_grad_(not self.frozen_towers)
        return model

    def draw(self, batch_size: int, latent_shape, generator, device
             ) -> tuple:
        """``(timesteps [B], noise, posterior noise)`` of one step, drawn
        in that order on the host from ``generator`` and moved to
        ``device``: timesteps uniform in ``[0, T)``, the two noises
        standard normal ``[B, C, H, W]``."""
        shape = (batch_size,) + tuple(latent_shape)
        timesteps = torch.randint(0, self.scheduler.num_train_timesteps,
                                  (batch_size,), generator=generator)
        noise = torch.randn(shape, generator=generator)
        posterior = torch.randn(shape, generator=generator)
        return (timesteps.to(device), noise.to(device),
                posterior.to(device))

    def denoise_pred(self, batch: dict) -> tuple:
        """``(pred, latents, noise, timesteps)`` of a batch (the part the
        dreambooth module shares)."""
        pixels = batch["pixel_values"]
        gen = self.dropout_generator
        draws = gen if gen is not None else torch.Generator().manual_seed(
            getattr(self.args, "seed", 42))
        timesteps, noise, posterior = self.draw(
            pixels.shape[0],
            self.model.vae_config.latent_shape(pixels.shape[2]), draws,
            pixels.device)
        pred, latents = self.model(
            batch["input_ids"], pixels, timesteps, noise,
            attention_mask=batch.get("attention_mask"),
            posterior_noise=posterior, deterministic=gen is None,
            dropout_rng=gen, frozen_towers=self.frozen_towers)
        return pred, latents, noise, timesteps

    def training_loss(self, batch: dict) -> tuple:
        pred, latents, noise, timesteps = self.denoise_pred(batch)
        return diffusion_loss(pred, latents, noise, timesteps,
                              self.scheduler, self.prediction_type), {}


def parser() -> argparse.ArgumentParser:
    """The module, Trainer, data and checkpoint flags, then the
    module's own."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.models.model_utils import add_module_args
    from fengshen_tpu_torch.trainer import add_trainer_args
    from fengshen_tpu_torch.utils.universal_checkpoint import \
        UniversalCheckpoint

    p = argparse.ArgumentParser()
    p = add_module_args(p)
    p = add_trainer_args(p)
    p = UniversalDataModule.add_data_specific_args(p)
    p = UniversalCheckpoint.add_argparse_args(p)
    return TaiyiSDModule.add_module_specific_args(p)


def main(argv=None, tokenizer=None, datasets=None):
    """Fit; return the Trainer (reference ``finetune.py`` :135-164)."""
    from fengshen_tpu_torch.data import UniversalDataModule
    from fengshen_tpu_torch.data.clip_dataloader import (
        ImageTextCSVDataset, SDCollator)
    from fengshen_tpu_torch.trainer import Trainer
    from fengshen_tpu_torch.utils.universal_checkpoint import \
        UniversalCheckpoint

    args = parser().parse_args(argv)
    trainer = Trainer(args)
    if tokenizer is None:
        from fengshen_tpu_torch.models.auto import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    if datasets is None and args.train_csv:
        datasets = {"train": ImageTextCSVDataset(
            args.train_csv, image_root=args.image_root)}
    collator = SDCollator(tokenizer, image_size=args.image_size,
                          max_length=args.max_length)
    datamodule = UniversalDataModule(tokenizer=tokenizer,
                                     collate_fn=collator, args=args,
                                     datasets=datasets)
    module = TaiyiSDModule(args, device=trainer.device)
    trainer.callbacks.append(UniversalCheckpoint(args))
    trainer.fit(module, datamodule)
    return trainer


if __name__ == "__main__":
    main()
