"""Image-text data for CLIP / SD: the port of
``fengshen_tpu/data/clip_dataloader/``."""

from fengshen_tpu_torch.data.clip_dataloader.image_text import (
    CLIPCollator, ImageTextCSVDataset, SDCollator, load_image)

__all__ = ["ImageTextCSVDataset", "CLIPCollator", "SDCollator",
           "load_image"]
