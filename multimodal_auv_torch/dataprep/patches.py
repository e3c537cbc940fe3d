"""Per-sample folder construction — ``process_and_save_data`` parity (port
of ``multimodal_auv_tpu/dataprep/patches.py``).

Reference: its Examples/Example_data_preparation.py:477-669. For each coords.csv row: a subfolder
named after the image stem containing the copied optical image,
``row_data.csv`` (row minus Image_Name/path), ``{label}.txt``, and for each
GeoTIFF a ``window_size_meters`` patch at (easting, northing) — Bathy
rasters with >=2 bands become ``output_channel_1.png``/``output_channel_2
.png``; everything else becomes ``grid_{last3nameparts}.png``.

GeoTIFFs are opened once and reused across all rows (the reference re-opens
per row x per file — the I/O hot loop of SURVEY.md §3.4); pass
``pack_cache_dir`` to pre-pack rasters to memmaps for sweep workloads.
"""
from __future__ import annotations

import csv
import logging
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from multimodal_auv_torch.dataprep.geotiff import GeoTiff, extract_grid_patch

logger = logging.getLogger(__name__)


def process_and_save_data(
    csv_file_path: str,
    geotiff_files_paths: List[str],
    output_root_folder: str,
    window_size_meters: float,
    original_images_folder: str,
    pack_cache_dir: Optional[str] = None,
) -> int:
    """Returns the number of successfully processed entries."""
    from PIL import Image

    os.makedirs(output_root_folder, exist_ok=True)

    try:
        with open(csv_file_path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
    except FileNotFoundError:
        logger.error("CSV file not found at %s; aborting", csv_file_path)
        return 0

    # open every raster once
    rasters: Dict[str, GeoTiff] = {}
    for p in geotiff_files_paths:
        try:
            g = GeoTiff.open(p)
            if pack_cache_dir:
                # pre-pack to a .npy memmap: every subsequent window read
                # is a pure slice instead of a strip/tile decode (the
                # sweep fast path this parameter advertises)
                g.to_memmap(pack_cache_dir)
            rasters[p] = g
        except Exception as e:
            logger.error("Could not open GeoTIFF %s: %s", p, e)

    processed = 0
    for row_idx, row in enumerate(rows):
        image_name = row.get("Image_Name", f"Unknown_Image_{row_idx}")
        try:
            src = row.get("path")
            if src and not os.path.isabs(src):
                src = os.path.join(original_images_folder, os.path.basename(src))
            elif not src and image_name:
                src = os.path.join(original_images_folder, image_name)
            if not src or not os.path.exists(src):
                logger.warning("Original image missing for %s; skipping",
                               image_name)
                continue

            label = row.get("label") or "unlabelled"
            out_dir = os.path.join(output_root_folder,
                                   os.path.splitext(image_name)[0])
            os.makedirs(out_dir, exist_ok=True)
            try:
                shutil.copy(src, out_dir)
            except Exception as e:
                logger.warning("Copy failed for %s: %s", src, e)

            # row_data.csv (row minus Image_Name/path)
            keep = [h for h in row.keys() if h not in ("Image_Name", "path")]
            with open(os.path.join(out_dir, "row_data.csv"), "w", newline="",
                      encoding="utf-8") as f:
                w = csv.writer(f)
                w.writerow(keep)
                w.writerow([row[h] for h in keep])

            with open(os.path.join(out_dir, f"{label}.txt"), "w",
                      encoding="utf-8") as f:
                f.write(label)

            e_raw, n_raw = row.get("easting"), row.get("northing")
            if not e_raw or not n_raw:
                logger.warning("No easting/northing for %s; skipping patches",
                               image_name)
                continue
            try:
                easting, northing = float(e_raw), float(n_raw)
            except ValueError:
                logger.warning("Invalid easting/northing for %s", image_name)
                continue
            if np.isnan(easting) or np.isnan(northing):
                continue

            for path, g in rasters.items():
                data, center, kind = extract_grid_patch(
                    g, easting, northing, window_size_meters)
                if data is None:
                    logger.debug("No patch from %s for %s", path, image_name)
                    continue
                base = os.path.splitext(os.path.basename(path))[0]
                final_three = "_".join(base.split("_")[-3:])
                if kind.lower() == "bathy":
                    if data.ndim == 3 and data.shape[0] >= 2:
                        Image.fromarray(data[0].astype(np.uint8)).save(
                            os.path.join(out_dir, "output_channel_1.png"))
                        Image.fromarray(data[1].astype(np.uint8)).save(
                            os.path.join(out_dir, "output_channel_2.png"))
                    else:
                        logger.warning(
                            "Bathy %s has <2 bands; skipping channel save", base)
                else:
                    arr = data[0] if data.ndim == 3 else data
                    Image.fromarray(arr.astype(np.uint8)).save(
                        os.path.join(out_dir, f"grid_{final_three}.png"))
            processed += 1
        except Exception as e:
            logger.error("Critical error processing %s: %s", image_name, e)
    return processed
