"""TrainModule: the port of ``fengshen_tpu/trainer/module.py:21``.

A module owns the model, its loss and its optimizer configuration; the
Trainer owns the device, the step loop and logging. Where the reference
passes params into a pure loss, the port's model holds its parameters:
:meth:`init_params` makes them from a generator and returns the model,
and :meth:`training_loss` reads them from the model.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from fengshen_tpu_torch.models import model_utils


class TrainModule:
    """Subclass and implement ``init_params`` and ``training_loss``;
    ``validation_loss`` defaults to the training loss without gradients,
    and a module that predicts defines ``predict_step(batch, **kw)``."""

    def __init__(self, args: Any):
        self.args = args

    # -- model -----------------------------------------------------------
    def setup(self, stage: str = "fit") -> None:
        """Called once before fit."""

    def init_params(self, generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    # -- losses ----------------------------------------------------------
    def training_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def validation_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss and metrics without gradients (:51)."""
        with torch.no_grad():
            return self.training_loss(batch)

    # -- optimization ----------------------------------------------------
    def configure_optimizers(self, total_steps: int,
                             model: torch.nn.Module):
        return model_utils.configure_optimizers(self.args, total_steps,
                                                model)

    # -- accounting ------------------------------------------------------
    def flops_per_token(self) -> Optional[float]:
        return None

    def tokens_in_batch(self, batch: Any) -> int:
        for key in ("input_ids", "tokens"):
            if isinstance(batch, dict) and key in batch:
                return int(np.prod(np.shape(batch[key])))
        return 0
