"""run_auv_preprocessing — the 4-step offline ETL pipeline (port of
``multimodal_auv_tpu/pipelines/preprocessing.py``). Host work: it takes no
device.

Reference: its functions/functions.py:261-359:
  1. preprocess_optical_images (enhance + telemetry -> coords.csv),
  2. enumerate GeoTIFFs + pixel resolutions,
  3. process_and_save_data (per-row patch extraction -> sample folders),
  4. process_frame_channels_in_subfolders (bathy channel combine),
     unless skip_bathy_combine.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from multimodal_auv_torch.dataprep.combine import process_frame_channels_in_subfolders
from multimodal_auv_torch.dataprep.geotiff import get_pixel_resolution
from multimodal_auv_torch.dataprep.optical import preprocess_optical_images
from multimodal_auv_torch.dataprep.patches import process_and_save_data
from multimodal_auv_torch.dataprep.utilities import is_geotiff

logger = logging.getLogger(__name__)


def run_auv_preprocessing(
    raw_optical_images_folder: str,
    geotiff_folder: str,
    output_folder: str,
    exiftool_path: Optional[str] = None,
    window_size_meters: float = 20.0,
    image_enhancement_method: str = "AverageSubtraction",
    skip_bathy_combine: bool = False,
) -> str:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    os.makedirs(output_folder, exist_ok=True)
    processed_dir = os.path.join(output_folder, "processed_optical")

    # Step 1: optical preprocessing -> coords.csv
    logger.info("Step 1/4: optical preprocessing")
    preprocess_optical_images(
        raw_optical_images_folder, processed_dir,
        image_enhancement_method=image_enhancement_method,
        exiftool_path=exiftool_path)
    coords_csv = os.path.join(processed_dir, "coords.csv")

    # Step 2: enumerate GeoTIFFs (+ log resolutions)
    logger.info("Step 2/4: enumerating GeoTIFFs")
    geotiffs = [os.path.join(geotiff_folder, f)
                for f in sorted(os.listdir(geotiff_folder)) if is_geotiff(f)]
    for g in geotiffs:
        try:
            logger.info("  %s resolution=%s", os.path.basename(g),
                        get_pixel_resolution(g))
        except Exception as e:
            logger.warning("  %s unreadable: %s", g, e)

    # Step 3: patch extraction into per-sample folders
    logger.info("Step 3/4: extracting patches for %d rows x %d rasters",
                sum(1 for _ in open(coords_csv)) - 1, len(geotiffs))
    samples_dir = os.path.join(output_folder, "samples")
    n = process_and_save_data(coords_csv, geotiffs, samples_dir,
                              window_size_meters, processed_dir)
    logger.info("  %d entries processed", n)

    # Step 4: bathy channel combine
    if not skip_bathy_combine:
        logger.info("Step 4/4: combining bathy channels")
        c = process_frame_channels_in_subfolders(samples_dir)
        logger.info("  %d folders combined", c)
    else:
        logger.info("Step 4/4 skipped (skip_bathy_combine)")
    return samples_dir
