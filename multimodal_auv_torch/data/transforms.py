"""Host-side image decode / resize / normalise (port of
``multimodal_auv_tpu/data/transforms.py``).

Resize((256, 256)) bilinear -> /255 -> optional per-channel normalisation
with the survey's optical constants. Arrays are NHWC float32. The port's
C++ host runtime (``native/``, built at first use) decodes and resizes
when it is available, as the JAX package's does; PIL is the fallback, and
is imported only inside the functions that decode, so the rest of the port
imports without it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE, OPTICAL_MEAN, OPTICAL_STD

_MEAN = np.asarray(OPTICAL_MEAN, np.float32)
_STD = np.asarray(OPTICAL_STD, np.float32)


def _native_lib():
    """The C++ host runtime, built at first use (None without a
    compiler)."""
    from multimodal_auv_torch import native

    return native.lib


def load_image_u8(path: str, mode: str = "RGB",
                  size: Tuple[int, int] = (IMAGE_SIZE, IMAGE_SIZE)
                  ) -> np.ndarray:
    """Decode + bilinear resize to uint8 (H, W, C); grayscale ('L') keeps a
    trailing channel dim of 1.

    The one decode / resize dispatch of the unpacked loader (``load_image``)
    and the packed caches (data/packing.py), as in the JAX package: with the
    native runtime built, the whole chain (libjpeg / libpng decode, PIL's L24
    convert, bilinear resize) is one C call, the same pixels as PIL's decode
    and convert followed by the native resize (tests/test_torch_native.py);
    other formats, and a runtime built without libjpeg, decode with PIL and
    resize natively; without the runtime PIL resizes too."""
    lib = _native_lib()
    if lib is not None and lib.has_decode and mode in ("RGB", "L"):
        with open(path, "rb") as f:
            # None for what the C path does not decode: PIL below
            out = lib.decode_image(f.read(), mode, size[0], size[1])
        if out is not None:
            return out
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert(mode)
        if img.size != (size[1], size[0]):
            if lib is not None:
                arr = np.asarray(img, np.uint8)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                return lib.resize_batch(arr[None], size[0], size[1],
                                        nthreads=1)[0]
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
