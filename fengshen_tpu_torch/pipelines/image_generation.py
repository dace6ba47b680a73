"""Text-to-image pipeline: the port of
``fengshen_tpu/pipelines/image_generation.py``, the Taiyi Stable
Diffusion inference surface and the hook the ``batch_image`` engine
(``serving/multimodal.py``) drives.

Encode the prompts with the Chinese text tower, walk a subsampled DDPM
schedule over latent noise, decode with the VAE, and return each image
as raw uint8 RGB bytes in base64 (:meth:`Pipeline._pack`; no image
codec needed). :meth:`Pipeline.run_batch` runs one micro-batch of
prompts through one denoise loop, counts ``fstpu_pipeline_images_total``
and times the ``pipeline/image_batch`` span.

Inject ``module=`` (a ``TaiyiStableDiffusion`` holding its weights)
and optionally a ``tokenizer`` (``encode(text) -> ids``; None is
:func:`byte_encode`), or set ``small_test=True`` for the compact random
towers. ``model=`` (a
checkpoint directory) raises ``ValueError``, as the JAX pipeline's
does: a released Taiyi-SD checkpoint is three towers to convert with
``models.stable_diffusion.convert``. The latent is sized by the VAE
config's ``latent_shape``, so the full SD-1.x VAE serves (the JAX
pipeline reads ``channel_mults``, which only the compact config has).
The initial latents of a call are drawn from ``(seed, call count)``.
"""

from __future__ import annotations

import base64
from typing import Any, Optional

import numpy as np
import torch


def byte_encode(text: str, vocab_size: int, max_len: int) -> np.ndarray:
    """The small-test towers' tokenizer: UTF-8 bytes folded into ``[3,
    vocab)``, padded with 0 to ``max_len``."""
    ids = [3 + (b % (vocab_size - 3))
           for b in text.encode("utf-8")[:max_len]]
    return np.asarray(ids + [0] * (max_len - len(ids)), np.int32)


class Pipeline:
    """Taiyi Stable Diffusion text-to-image. ``device`` (None means
    ``cuda``, raising without a card) is where ``small_test`` builds its
    towers; an injected module keeps its own device."""

    task = "image_generation"

    def __init__(self, args: Any = None, model: Optional[str] = None,
                 module: Any = None, tokenizer: Any = None,
                 image_size: int = 32,
                 num_inference_steps: int = 4, max_text_len: int = 16,
                 seed: int = 0, small_test: bool = False, device=None):
        if args is not None:
            image_size = getattr(args, "image_size", image_size)
            num_inference_steps = getattr(args, "num_inference_steps",
                                          num_inference_steps)
        if module is None and small_test:
            from fengshen_tpu_torch.device import resolve_device
            module = self._build_small_test(seed, resolve_device(device))
        if module is None:
            if model is None:
                raise ValueError(
                    "image_generation needs an injected module or "
                    "small_test=True")
            raise ValueError(
                "model= checkpoint assembly is not wired for "
                "image_generation; convert the towers with "
                "models.stable_diffusion.convert and inject module= "
                "(or use small_test=True)")
        self.module = module.eval()
        self.device = next(module.parameters()).device
        self.tokenizer = tokenizer
        self.image_size = int(image_size)
        self.num_inference_steps = int(num_inference_steps)
        self.max_text_len = int(max_text_len)
        self.seed = seed
        self._n_calls = 0

    @staticmethod
    def _build_small_test(seed: int, device):
        from fengshen_tpu_torch.models.bert import BertConfig
        from fengshen_tpu_torch.models.stable_diffusion import (
            TaiyiStableDiffusion, UNetConfig, VAEConfig)
        text_cfg = BertConfig(vocab_size=128, hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=64,
                              max_position_embeddings=64, dtype="float32")
        return TaiyiStableDiffusion(
            text_cfg, VAEConfig.small_test_config(),
            UNetConfig.small_test_config(cross_attention_dim=32),
            device=device,
            generator=torch.Generator(device=device).manual_seed(seed))

    # ---- engine integration -----------------------------------------

    def encode(self, text: str) -> np.ndarray:
        if self.tokenizer is not None:
            ids = list(self.tokenizer.encode(text))[:self.max_text_len]
            ids += [0] * (self.max_text_len - len(ids))
            return np.asarray(ids, np.int32)
        return byte_encode(text, self.module.text_config.vocab_size,
                           self.max_text_len)

    def warmup_input(self) -> str:
        return "warmup"

    def draw_latents(self, batch: int) -> torch.Tensor:
        """This call's initial latents ``[B, C, H, W]``: drawn on the host
        from a generator seeded by ``(seed, call count)``."""
        gen = torch.Generator().manual_seed(
            (int(self.seed) << 32) + self._n_calls)
        shape = (batch,) + tuple(
            self.module.vae_config.latent_shape(self.image_size))
        return torch.randn(shape, generator=gen).to(self.device)

    def generate(self, input_ids: torch.Tensor,
                 latents: torch.Tensor) -> torch.Tensor:
        """One batch through :func:`sampling.text_to_image` without
        guidance, over the pipeline's own schedule (a float64
        ``linspace(T - 1, 0, n)`` truncated, as the JAX pipeline walks
        it) -> ``[B, H, W, 3]`` in [0, 1]."""
        from fengshen_tpu_torch.models.stable_diffusion.sampling import \
            text_to_image
        from fengshen_tpu_torch.models.stable_diffusion.scheduler import \
            DDPMScheduler
        scheduler = DDPMScheduler()
        steps = np.linspace(scheduler.num_train_timesteps - 1, 0,
                            self.num_inference_steps, dtype=np.int64)
        return text_to_image(self.module, input_ids, latents=latents,
                             scheduler=scheduler, timesteps=steps)

    def run_batch(self, texts: list) -> list:
        """The ``BatchImageEngine`` hook: one denoise loop for the whole
        micro-batch, its draw from ``(seed, call count)`` (so repeated
        prompts differ and a run is reproducible from ``seed``)."""
        from fengshen_tpu_torch.observability import get_registry, span
        self._n_calls += 1
        ids = torch.as_tensor(np.stack([self.encode(t) for t in texts]),
                              device=self.device)
        latents = self.draw_latents(len(texts))
        with span("pipeline/image_batch"):
            images = self.generate(ids, latents).float().cpu().numpy()
        get_registry().counter(
            "fstpu_pipeline_images_total",
            "images generated by the batch-image pipeline"
        ).inc(len(texts))
        return [self._pack(img) for img in images]

    @staticmethod
    def _pack(img: np.ndarray) -> dict:
        """A JSON-safe result: raw uint8 RGB bytes in base64, ``shape``
        ``[H, W, 3]``."""
        u8 = (img * 255.0 + 0.5).astype(np.uint8)
        return {"image_b64": base64.b64encode(u8.tobytes()).decode(),
                "shape": list(u8.shape), "dtype": "uint8"}

    # ---- the one-request path -----------------------------------------

    def __call__(self, input_text: str) -> dict:
        return self.run_batch([input_text])[0]

    @staticmethod
    def add_pipeline_specific_args(parser):
        parser.add_argument("--image_size", default=32, type=int)
        parser.add_argument("--num_inference_steps", default=4, type=int)
        return parser
