"""Host-side image decode / resize / normalise (port of
``multimodal_auv_tpu/data/transforms.py``, PIL path only).

Resize((256, 256)) bilinear -> /255 -> optional per-channel normalisation
with the survey's optical constants. Arrays are NHWC float32. The JAX
package's native decoder is pinned pixel-exact with PIL by its tests, so PIL
alone feeds the same pixels. PIL is imported only inside the functions that
decode, since the machine with the card has no PIL.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE, OPTICAL_MEAN, OPTICAL_STD

_MEAN = np.asarray(OPTICAL_MEAN, np.float32)
_STD = np.asarray(OPTICAL_STD, np.float32)


def load_image_u8(path: str, mode: str = "RGB",
                  size: Tuple[int, int] = (IMAGE_SIZE, IMAGE_SIZE)
                  ) -> np.ndarray:
    """Decode + bilinear resize to uint8 (H, W, C); grayscale ('L') keeps a
    trailing channel dim of 1."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert(mode)
        if img.size != (size[1], size[0]):
            img = img.resize((size[1], size[0]), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def load_image(path: str, mode: str = "RGB",
               size: Tuple[int, int] = (IMAGE_SIZE, IMAGE_SIZE)) -> np.ndarray:
    """Decode + resize + scale to [0, 1], (H, W, C) f32."""
    return load_image_u8(path, mode, size).astype(np.float32) / 255.0


def normalize_optical(arr: np.ndarray) -> np.ndarray:
    """Per-channel (x - mean) / std for the main optical image."""
    return (arr - _MEAN) / _STD


def load_main_image(path: str,
                    size: Tuple[int, int] = (IMAGE_SIZE, IMAGE_SIZE)
                    ) -> np.ndarray:
    return normalize_optical(load_image(path, "RGB", size))


def zeros(channels: int, size: int = IMAGE_SIZE) -> np.ndarray:
    return np.zeros((size, size, channels), np.float32)


def image_nonzero_count(path: str, mode: Optional[str] = None) -> int:
    from PIL import Image

    with Image.open(path) as img:
        if mode:
            img = img.convert(mode)
        return int(np.count_nonzero(np.asarray(img)))


def image_sum(path: str) -> float:
    from PIL import Image

    with Image.open(path) as img:
        return float(np.asarray(img).sum())
