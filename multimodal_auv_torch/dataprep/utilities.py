"""Misc dataprep helpers (port of ``multimodal_auv_tpu/dataprep/utilities.py``,
the reference's data_preparation/utilities.py:5-85), on the ``csv`` module:
rows are dicts of the file's strings, where the JAX package returns pandas
DataFrames."""
from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# the reference accepts exactly .tif/.tiff (utilities.py:7) — no .gtiff,
# which would classify files the reference pipeline skips
_GEOTIFF_SUFFIXES = (".tif", ".tiff")


def is_geotiff(file: str) -> bool:
    return file.lower().endswith(_GEOTIFF_SUFFIXES)


def _read_rows(csv_file_path: str):
    """(header, rows) of a CSV file."""
    with open(csv_file_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return list(reader.fieldnames or []), rows


def filter_csv_by_image_names(csv_file_path: str,
                              image_folder_path: str) -> List[Dict[str, str]]:
    """Keep only coords.csv rows whose Image_Name exists in the folder.

    Degrades like the reference (utilities.py:21-35): a missing/unreadable
    CSV returns no rows, a missing image folder filters against an empty
    name set — pipelines continue instead of crashing mid-ETL."""
    try:
        header, rows = _read_rows(csv_file_path)
    except FileNotFoundError:
        logger.error("CSV file not found at %s", csv_file_path)
        return []
    except Exception as e:
        logger.error("Error loading CSV %s: %s", csv_file_path, e)
        return []
    if os.path.exists(image_folder_path):
        names = set(os.listdir(image_folder_path))
    else:
        logger.warning("Image folder not found at %s — no rows will match",
                       image_folder_path)
        names = set()
    if "Image_Name" not in header:
        # reference utilities.py:37-43: no Image_Name column -> return the
        # rows UNFILTERED (with an error log), not a KeyError
        logger.error("'Image_Name' column not found in CSV %s — returning "
                     "unfiltered rows", csv_file_path)
        return rows
    out = [r for r in rows if r["Image_Name"] in names]
    logger.info("Filtered %d -> %d rows by image presence", len(rows),
                len(out))
    return out


def update_csv_path(csv_file_path: str, old_prefix: str,
                    new_prefix: str) -> Optional[List[Dict[str, str]]]:
    """Rewrite the 'path' column prefix in place (drive/mount moves).

    Degrades like the reference (utilities.py:46-90): missing file or
    missing 'path' column logs an error and leaves the file untouched.
    Returns the rewritten rows on success, None on error (the reference
    returns None always; callers in both stacks ignore it)."""
    try:
        header, rows = _read_rows(csv_file_path)
    except FileNotFoundError:
        logger.error("CSV file '%s' not found.", csv_file_path)
        return None
    if "path" not in header:
        logger.error("'path' column not found in CSV header of %s",
                     csv_file_path)
        return None
    for r in rows:
        r["path"] = r["path"].replace(old_prefix, new_prefix)
    with open(csv_file_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=header, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    logger.info("CSV file '%s' updated successfully.", csv_file_path)
    return rows
