"""Data layer: samplers and the local-file datamodule."""

from fengshen_tpu_torch.data.universal_datamodule import (DataLoader,
                                                          UniversalDataModule)
from fengshen_tpu_torch.data.universal_sampler import (
    PretrainingRandomSampler, PretrainingSampler)

__all__ = ["DataLoader", "PretrainingRandomSampler", "PretrainingSampler",
           "UniversalDataModule"]
