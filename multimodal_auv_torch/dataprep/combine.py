"""Bathy channel combine — ``process_frame_channels_in_subfolders`` parity
(port of ``multimodal_auv_tpu/dataprep/combine.py``), without cv2.

Reference: its data_preparation/image_processing.py:8-74. Per subfolder:
delete stale ``demeaned``/``average_subtracted`` files, then merge
``output_channel_1/2`` grayscale images into a 3-channel
``combined_channels.png``.

The JAX package reads with ``cv2.imread(IMREAD_GRAYSCALE)``, resizes with
``cv2.resize`` (INTER_LINEAR) and writes with ``cv2.imwrite``. Here:

* read (``read_gray_u8``): PIL. 8-bit gray files pass through; colour
  PNGs take libpng's fixed-point rgb_to_gray (what cv2's PNG decoder asks
  libpng for; alpha dropped, palettes expanded); JPEGs decode their luma
  plane alone (libjpeg's grayscale output, as cv2 gets it); other colour
  files take cv2's ``cvtColor`` BGR->gray rule.
* resize (``resize_linear_u8``): bilinear with cv2's half-pixel centres,
  edge clamping and weights rounded to 11-bit fixed point. cv2's SIMD
  rows round their products in another order, so a resized plane is
  within 1 LSB of cv2's; an unresized one is equal.
* write: cv2 writes its array as BGR, so the PNG's RGB is (0, ch2, ch1);
  PIL writes that order.
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

# cv2's INTER_RESIZE_COEF_BITS: interpolation weights in 11-bit fixed point
_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def read_gray_u8(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for 8-bit images."""
    from PIL import Image

    with Image.open(path) as img:
        if img.format == "JPEG" and img.mode != "L":
            img.draft("L", img.size)  # the luma plane, as libjpeg gives it
        if img.mode == "L":
            return np.asarray(img, np.uint8).copy()
        rgb = np.asarray(img.convert("RGB"), np.int64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        if img.format == "PNG":
            # libpng's png_set_rgb_to_gray(1, 0.299, 0.587), 15-bit
            gray = (r * 9797 + g * 19234 + b * 3737) >> 15
        else:
            # cv2's cvtColor(BGR2GRAY), 14-bit with rounding
            gray = (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14
        return gray.astype(np.uint8)


def _linear_taps(dst: int, src: int):
    """Per output index: the two source taps and their 11-bit weights,
    with cv2's half-pixel centres and edge clamping."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    low = i0 < 0
    f[low], i0[low] = 0.0, 0
    high = i0 >= src - 1
    f[high], i0[high] = 0.0, src - 1
    i1 = np.minimum(i0 + 1, src - 1)
    w0 = np.rint((1.0 - f) * _COEF_ONE).astype(np.int64)
    return i0, i1, w0, _COEF_ONE - w0


def resize_linear_u8(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(a, (width, height))`` (INTER_LINEAR) of a uint8 plane,
    in cv2's fixed-point arithmetic: within 1 LSB of cv2."""
    y0, y1, wy0, wy1 = _linear_taps(height, a.shape[0])
    x0, x1, wx0, wx1 = _linear_taps(width, a.shape[1])
    a = a.astype(np.int64)
    rows = a[:, x0] * wx0 + a[:, x1] * wx1
    out = (rows[y0] * wy0[:, None] + rows[y1] * wy1[:, None]
           + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


def process_frame_channels_in_subfolders(root_folder: str) -> int:
    from PIL import Image

    if not os.path.exists(root_folder):
        logger.warning("Root folder not found: %s", root_folder)
        return 0

    combined = 0
    for name in os.listdir(root_folder):
        sub = os.path.join(root_folder, name)
        if not os.path.isdir(sub):
            continue

        for filename in os.listdir(sub):
            if "demeaned" in filename or "average_subtracted" in filename:
                try:
                    os.remove(os.path.join(sub, filename))
                except OSError as e:
                    logger.warning("Error deleting %s: %s", filename, e)

        ch1 = ch2 = None
        for filename in os.listdir(sub):
            p = os.path.join(sub, filename)
            if not os.path.isfile(p):
                continue
            # cv2.imread returns None for a file it cannot decode
            try:
                if "output_channel_1" in filename:
                    ch1 = read_gray_u8(p)
                elif "output_channel_2" in filename:
                    ch2 = read_gray_u8(p)
            except Exception as e:
                logger.warning("Could not read %s: %s", p, e)

        if ch1 is None or ch2 is None:
            logger.debug("Both channels not found in %s; skipping", sub)
            continue

        h, w = ch1.shape
        if ch2.shape != (h, w):
            ch2 = resize_linear_u8(ch2, w, h)
        # cv2 writes planes (ch1, ch2, 0) as B, G, R
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[:, :, 1] = ch2
        rgb[:, :, 2] = ch1
        Image.fromarray(rgb, "RGB").save(
            os.path.join(sub, "combined_channels.png"))
        combined += 1
    return combined
