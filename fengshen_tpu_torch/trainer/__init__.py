"""Trainer: the training loop of the port (one device so far).

``TrainModule`` is the module contract, ``TrainState`` the model,
optimizer and scheduler with the step counters, and ``Trainer`` the loop
(see :mod:`.trainer` for what is ported and what is refused).
"""

from fengshen_tpu_torch.trainer.module import TrainModule
from fengshen_tpu_torch.trainer.train_state import TrainState
from fengshen_tpu_torch.trainer.trainer import Trainer, add_trainer_args

__all__ = ["TrainModule", "TrainState", "Trainer", "add_trainer_args"]
