"""Optical image preprocessing — ``preprocess_optical_images`` parity (port
of ``multimodal_auv_tpu/dataprep/optical.py``).

Reference: its Examples/Example_data_preparation.py:28-474. Pipeline per
survey folder of raw GAVIA JPEGs:

  1. recursive ``**/*.jpg`` glob;
  2. telemetry from the EXIF/JPEG comment (exif.py; exiftool-compatible);
  3. lat/lon (ddmm.mmm + hemisphere letter) -> decimal degrees -> UTM
     easting/northing with auto zone floor((lon+180)/6)+1 (geodesy.py);
  4. enhancement: AverageSubtraction (subtract per-folder mean image, then
     rescale_intensity to uint8) or CLAHE (gray -> adaptive equalization ->
     replicated RGB; cv2-based);
  5. save processed JPEGs + per-folder ``*_Average.png`` + ``coords.csv``
     with the exact reference columns (Image_Name, path, easting, northing,
     altitude, depth [negated for display], heading, lat, lon, pitch, roll,
     surge, sway, label).

Decode and mean-accumulation are threaded (PIL releases the GIL). The
CSV is written with the ``csv`` module, byte-equal to the JAX package's
pandas ``to_csv``: floats as their shortest repr, missing values empty,
"\n" line ends. PIL is imported inside the functions that decode or
encode, and cv2 only by the ``CLAHE_CV2`` path.
"""
from __future__ import annotations

import csv
import glob
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from multimodal_auv_torch.dataprep import exif
from multimodal_auv_torch.dataprep.geodesy import latlon_to_utm

logger = logging.getLogger(__name__)


def rescale_intensity_uint8(arr: np.ndarray) -> np.ndarray:
    """skimage.exposure.rescale_intensity(..., out_range='uint8') parity:
    linear map [min, max] -> [0, 255]."""
    arr = arr.astype(np.float64)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        return np.zeros(arr.shape, np.uint8)
    return np.clip((arr - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


def apply_clahe_rgb(img_uint8: np.ndarray, clip_limit: float = 2.0,
                    grid: int = 8) -> np.ndarray:
    """CLAHE on the grayscale projection, replicated back to RGB — the
    fast cv2 path. NOTE (PARITY.md): the reference's
    ``skimage.exposure.equalize_adapthist`` on an RGB image equalizes the
    HSV *value* channel and keeps hue/saturation — this gray-replicate
    variant discards color entirely. ``equalize_adapthist_rgb`` below is
    the reference-faithful (color-preserving) default."""
    import cv2

    if img_uint8.ndim == 3 and img_uint8.shape[2] == 3:
        gray = cv2.cvtColor(img_uint8, cv2.COLOR_RGB2GRAY)
    else:
        gray = img_uint8 if img_uint8.ndim == 2 else img_uint8[:, :, 0]
    clahe = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(grid, grid))
    eq = clahe.apply(gray)
    return np.repeat(eq[:, :, None], 3, axis=2)


def clahe_u8(channel: np.ndarray, clip_limit: float = 0.01,
             kernel_size=None, nbins: int = 256) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of one uint8
    channel — the classic Zuiderveld algorithm with skimage
    ``equalize_adapthist`` PARAMETER semantics: ``kernel_size`` defaults
    to shape//8 per axis and ``clip_limit`` is the FRACTION of a tile's
    pixels at which histogram bins are clipped (skimage default 0.01;
    cv2's ``clipLimit=L`` corresponds to L*tile_px/nbins, so 0.01 here
    ~= cv2 clipLimit 2.56). Tile mappings are bilinearly interpolated at
    every pixel (tile centers as knots, edges clamped)."""
    h, w = channel.shape
    if kernel_size is None:
        th, tw = max(h // 8, 1), max(w // 8, 1)
    elif np.isscalar(kernel_size):
        th = tw = int(kernel_size)  # skimage accepts a scalar: same per axis
    else:
        th, tw = kernel_size
    ny, nx = -(-h // th), -(-w // tw)
    pad_y, pad_x = ny * th - h, nx * tw - w
    padded = np.pad(channel, ((0, pad_y), (0, pad_x)), mode="reflect")

    # per-tile clipped-histogram equalization mapping
    tiles = padded.reshape(ny, th, nx, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(ny * nx, th * tw)
    maps = np.empty((ny * nx, nbins), np.float64)
    clip = max(clip_limit * th * tw, 1.0)
    scale = (nbins - 1) / 255.0
    for i in range(ny * nx):
        hist = np.bincount((tiles[i] * scale + 0.5).astype(np.int64),
                           minlength=nbins).astype(np.float64)
        excess = np.maximum(hist - clip, 0.0).sum()
        hist = np.minimum(hist, clip) + excess / nbins
        cdf = np.cumsum(hist)
        maps[i] = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1.0) * 255.0
    maps = maps.reshape(ny, nx, nbins)

    # bilinear interpolation between the four surrounding tile mappings
    yy = (np.arange(h) + 0.5) / th - 0.5
    xx = (np.arange(w) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, ny - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    x1 = np.minimum(x0 + 1, nx - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]

    b = (channel[:h, :w].astype(np.float64) * scale + 0.5).astype(np.int64)
    v00 = maps[y0[:, None], x0[None, :], b]
    v01 = maps[y0[:, None], x1[None, :], b]
    v10 = maps[y1[:, None], x0[None, :], b]
    v11 = maps[y1[:, None], x1[None, :], b]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def equalize_adapthist_rgb(img_uint8: np.ndarray, clip_limit: float = 0.01,
                           kernel_size=None) -> np.ndarray:
    """Reference-faithful color CLAHE: ``skimage.exposure.
    equalize_adapthist`` semantics for an RGB input — convert to HSV,
    equalize the VALUE channel only, convert back (hue/saturation — the
    image's color — preserved; Example_data_preparation.py:134). The cv2
    gray-replicate path (``apply_clahe_rgb``) discards color, which is a
    gross divergence for a color survey camera; divergence numbers are in
    PARITY.md."""
    if img_uint8.ndim == 2 or (img_uint8.ndim == 3 and img_uint8.shape[2] == 1):
        ch = img_uint8 if img_uint8.ndim == 2 else img_uint8[:, :, 0]
        eq = clahe_u8(ch, clip_limit, kernel_size)
        return np.repeat(eq[:, :, None], 3, axis=2)

    rgb = img_uint8.astype(np.float64) / 255.0
    mx = rgb.max(axis=2)
    mn = rgb.min(axis=2)
    v_eq = clahe_u8(np.clip(mx * 255.0 + 0.5, 0, 255).astype(np.uint8),
                    clip_limit, kernel_size).astype(np.float64) / 255.0
    # rescale R,G,B about the value channel (keeps H and S exactly:
    # hue and saturation are invariant under V *= c with chroma scaled)
    ratio = np.where(mx > 0, v_eq / np.maximum(mx, 1e-12), 0.0)
    out = rgb * ratio[:, :, None]
    # zero-value pixels: take the equalized value as gray
    out = np.where((mx == 0)[:, :, None], v_eq[:, :, None], out)
    del mn
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _load_rgb_float(path: str) -> Optional[np.ndarray]:
    from PIL import Image

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.float64)
    except Exception as e:
        logger.warning("Could not read image %s: %s", path, e)
        return None


def compute_folder_averages(files: List[str], save_folder: str,
                            workers: int = 8) -> Dict[str, np.ndarray]:
    """Per-folder mean image (saved as <folder>_Average.png)."""
    from PIL import Image

    by_folder: Dict[str, List[str]] = {}
    for f in files:
        by_folder.setdefault(os.path.dirname(f), []).append(f)

    averages: Dict[str, np.ndarray] = {}
    for folder, folder_files in by_folder.items():
        acc = None
        count = 0
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for arr in pool.map(_load_rgb_float, folder_files):
                if arr is None:
                    continue
                if acc is None:
                    acc = np.zeros_like(arr)
                if arr.shape == acc.shape:
                    acc += arr
                    count += 1
                else:
                    logger.warning("Inconsistent dims in %s; skipped for avg",
                                   folder)
        if acc is not None and count > 0:
            avg = acc / count
            averages[folder] = avg
            out = os.path.join(save_folder,
                               os.path.basename(folder) + "_Average.png")
            try:
                Image.fromarray(np.round(avg).astype(np.uint8), "RGB").save(out)
            except Exception as e:
                logger.warning("Could not save average image %s: %s", out, e)
    return averages


def preprocess_optical_images(
    raw_optical_images_folder: str,
    processed_images_save_folder: str,
    image_enhancement_method: str = "AverageSubtraction",
    exiftool_path: Optional[str] = None,
    workers: int = 8,
) -> List[Dict[str, object]]:
    """Returns (and writes) the coords.csv rows."""
    from PIL import Image

    os.makedirs(processed_images_save_folder, exist_ok=True)
    files = sorted(
        glob.glob(os.path.join(raw_optical_images_folder, "**", "*.jpg"),
                  recursive=True))
    logger.info("Found %d raw optical images", len(files))

    comments = exif.get_comments(files, exiftool_path)

    folder_averages: Dict[str, np.ndarray] = {}
    if image_enhancement_method == "AverageSubtraction":
        folder_averages = compute_folder_averages(
            files, processed_images_save_folder, workers)

    rows = []
    for file_path in files:
        image_basename = os.path.basename(file_path)
        tele = exif.parse_telemetry(comments.get(os.path.abspath(file_path), ""))
        lat, lon = tele.get("lat", float("nan")), tele.get("lon", float("nan"))
        easting = northing = float("nan")
        if not (math.isnan(lat) or math.isnan(lon)):
            try:
                easting, northing, zone, _ = latlon_to_utm(lat, lon)
            except Exception as e:
                logger.warning("UTM conversion failed for %s: %s",
                               image_basename, e)

        save_image_path = os.path.join(processed_images_save_folder,
                                       image_basename)
        try:
            im1 = _load_rgb_float(file_path)
            if im1 is None:
                raise IOError("unreadable image")
            if image_enhancement_method == "AverageSubtraction":
                avg = folder_averages.get(os.path.dirname(file_path))
                if avg is not None and avg.shape == im1.shape:
                    out2 = rescale_intensity_uint8(im1 - avg)
                else:
                    logger.warning("No folder average for %s; saving original",
                                   image_basename)
                    out2 = im1.astype(np.uint8)
            elif image_enhancement_method == "CLAHE":
                # reference-faithful: skimage-semantics color CLAHE
                # (HSV value channel; color preserved) — PARITY.md
                out2 = equalize_adapthist_rgb(im1.astype(np.uint8))
            elif image_enhancement_method == "CLAHE_CV2":
                # fast cv2 path (gray-replicate; color discarded)
                out2 = apply_clahe_rgb(im1.astype(np.uint8))
            else:
                logger.warning("Unknown enhancement %s; saving original",
                               image_enhancement_method)
                out2 = im1.astype(np.uint8)
            Image.fromarray(out2, "RGB").save(save_image_path)
        except Exception as e:
            logger.warning("Enhancement failed for %s: %s", image_basename, e)
            save_image_path = file_path

        depth = tele.get("depth", float("nan"))
        display_depth = -depth if not math.isnan(depth) else ""

        def s(name):
            v = tele.get(name, float("nan"))
            return str(v) if not math.isnan(v) else ""

        rows.append({
            "Image_Name": image_basename,
            "path": save_image_path,
            "easting": float(easting),
            "northing": float(northing),
            "altitude": s("altitude"),
            "depth": display_depth,
            "heading": s("heading"),
            "lat": str(lat) if not math.isnan(lat) else "",
            "lon": str(lon) if not math.isnan(lon) else "",
            "pitch": s("pitch"),
            "roll": s("roll"),
            "surge": s("surge"),
            "sway": s("sway"),
            "label": "unlabelled",
        })

    output_csv_path = os.path.join(processed_images_save_folder, "coords.csv")
    write_rows_csv(output_csv_path, rows)
    logger.info("Metadata saved to %s (%d entries)", output_csv_path,
                len(rows))
    return rows


def _csv_text(v) -> str:
    """A cell as pandas' ``to_csv`` writes it: NaN empty, floats as their
    shortest repr (numpy's ``astype(str)``, Python's ``repr``)."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_rows_csv(path: str, rows: List[Dict[str, object]]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)`` byte for byte, for
    rows whose columns hold str or float values: the first row's keys as
    the header; no rows writes one empty line, as pandas does."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(rows[0]) if rows else [])
        for r in rows:
            w.writerow([_csv_text(v) for v in r.values()])
