"""Image-text csv datasets and the CLIP / Stable Diffusion collators:
the port of ``fengshen_tpu/data/clip_dataloader/image_text.py``.

Images load through Pillow (resize of the shorter side, centre crop,
[0, 1]) as the JAX loader loads them; where Pillow is absent,
:func:`load_image` raises ``ImportError`` naming it. The collators give
the JAX collators' arrays in PyTorch's layout, NCHW: ``pixel_values``
``[B, 3, H, W]`` (SD: in [-1, 1]; CLIP: normalised by its mean and
std). A sample may carry its decoded image as ``pixels`` (``[H, W, 3]``
in [0, 1], the image size) instead of an ``image_path``, for callers
that hold images already.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


class ImageTextCSVDataset:
    """csv rows (image path, caption) -> ``{"image_path", "caption"}``;
    the separator is configurable (the reference's flickr csv uses
    tabs)."""

    def __init__(self, csv_path: str, image_root: Optional[str] = None,
                 image_key: str = "image", caption_key: str = "caption",
                 delimiter: str = ","):
        self.rows: list[dict] = []
        self.image_root = image_root or os.path.dirname(csv_path)
        with open(csv_path) as f:
            for row in csv.DictReader(f, delimiter=delimiter):
                self.rows.append({"image": row[image_key],
                                  "caption": row[caption_key]})

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        row = self.rows[i]
        path = row["image"]
        if not os.path.isabs(path):
            path = os.path.join(self.image_root, path)
        return {"image_path": path, "caption": row["caption"]}


def load_image(path: str, size: int) -> np.ndarray:
    """Pillow load -> resize of the shorter side to ``size`` -> centre
    crop -> ``[size, size, 3]`` float32 in [0, 1]. Raises
    ``ImportError`` naming Pillow where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "load_image needs Pillow (pip install Pillow) to decode "
            f"{path!r}; pass decoded images as a sample's 'pixels' "
            "instead") from e
    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(int(w * scale), size),
                      max(int(h * scale), size)))
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, np.float32) / 255.0


def _images(samples: list, size: int) -> np.ndarray:
    """``[B, size, size, 3]`` in [0, 1]: each sample's ``pixels``, else
    its ``image_path`` loaded."""
    out = []
    for s in samples:
        if "pixels" in s:
            img = np.asarray(s["pixels"], np.float32)
            if img.shape != (size, size, 3):
                raise ValueError(f"sample pixels of shape {img.shape}; "
                                 f"expected {(size, size, 3)}")
            out.append(img)
        else:
            out.append(load_image(s["image_path"], size))
    return np.stack(out)


def _encode(tokenizer, samples: list, max_length: int) -> dict:
    return tokenizer([s["caption"] for s in samples], padding="max_length",
                     truncation=True, max_length=max_length,
                     return_tensors="np")


@dataclass
class CLIPCollator:
    """captions + images -> a contrastive batch (Taiyi-CLIP)."""

    tokenizer: Any
    image_size: int = 224
    max_length: int = 77
    mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    std: tuple = (0.26862954, 0.26130258, 0.27577711)

    def __call__(self, samples: list) -> dict:
        enc = _encode(self.tokenizer, samples, self.max_length)
        images = _images(samples, self.image_size)
        images = (images - np.asarray(self.mean)) / np.asarray(self.std)
        return {"input_ids": enc["input_ids"].astype(np.int32),
                "attention_mask": enc["attention_mask"].astype(np.int32),
                "pixel_values": np.ascontiguousarray(
                    images.astype(np.float32).transpose(0, 3, 1, 2))}


@dataclass
class SDCollator:
    """captions + images -> a latent-diffusion batch, pixels in [-1, 1]
    (the reference's ``taiyi_datasets.py`` normalisation)."""

    tokenizer: Any
    image_size: int = 512
    max_length: int = 77

    def __call__(self, samples: list) -> dict:
        enc = _encode(self.tokenizer, samples, self.max_length)
        images = _images(samples, self.image_size)
        return {"input_ids": enc["input_ids"].astype(np.int32),
                "attention_mask": enc["attention_mask"].astype(np.int32),
                "pixel_values": np.ascontiguousarray(
                    (images * 2.0 - 1.0).astype(np.float32)
                    .transpose(0, 3, 1, 2))}
