"""The DDPM noise scheduler: the port of
``fengshen_tpu/models/stable_diffusion/scheduler.py`` (:18-73).

The betas are made in float64 numpy (``scaled_linear`` or ``linear``),
their cumulative product of ``1 - beta`` then held in fp32, as the JAX
scheduler holds it. ``add_noise`` and ``get_velocity`` (the
v-prediction target) serve training; ``step`` is one deterministic
ancestral step of a (possibly subsampled) inference schedule, with
``prev_timestep`` -1 meaning alpha 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class DDPMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"   # diffusers' SD default
    prediction_type: str = "epsilon"       # "epsilon" | "v_prediction"

    def __post_init__(self):
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                self.num_train_timesteps) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end,
                                self.num_train_timesteps)
        else:
            raise ValueError(f"unknown beta schedule {self.beta_schedule!r}")
        self.alphas_cumprod = torch.from_numpy(
            np.cumprod(1.0 - betas).astype(np.float32))

    def _gather(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``alphas_cumprod[t]`` for ``[B]`` timesteps, on ``like``'s
        device, broadcast against it."""
        a = self.alphas_cumprod.to(like.device)[t.to(like.device).long()]
        return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        a = self._gather(timesteps, sample)
        return torch.sqrt(a) * sample + torch.sqrt(1 - a) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps) -> torch.Tensor:
        """v = sqrt(a) eps - sqrt(1 - a) x (the v-prediction target)."""
        a = self._gather(timesteps, sample)
        return torch.sqrt(a) * noise - torch.sqrt(1 - a) * sample

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor,
             prev_timestep: Optional[int] = None) -> torch.Tensor:
        """One denoise step from ``timestep`` to ``prev_timestep`` (the
        next timestep of the inference schedule; default ``timestep -
        1``; a negative one means alpha 1, the clean image)."""
        if prev_timestep is None:
            prev_timestep = int(timestep) - 1
        ac = self.alphas_cumprod.to(sample.device)
        a_t = ac[int(timestep)]
        a_prev = ac[int(prev_timestep)] if int(prev_timestep) >= 0 else \
            torch.ones((), dtype=torch.float32, device=sample.device)
        if self.prediction_type == "v_prediction":
            eps = torch.sqrt(a_t) * model_output + \
                torch.sqrt(1 - a_t) * sample
        else:
            eps = model_output
        x0 = (sample - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps
