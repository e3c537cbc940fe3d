"""EXIF comment extraction for GAVIA AUV optical images (port of
``multimodal_auv_tpu/dataprep/exif.py``).

The reference shells out to ExifTool (``-G0 -j -File:Comment``, with
Windows 200-file chunking: its Examples/Example_data_preparation.py:
196-235) and regex-parses the telemetry comment.

Here: a built-in JPEG COM-segment / EXIF UserComment reader is the default
(no Perl dependency); ExifTool is used when available for byte-level parity.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import struct
import subprocess
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# GAVIA telemetry float fields (Example_data_preparation.py:309-328)
_FLOAT_FIELDS = ("altitude", "depth", "heading", "pitch", "roll", "surge",
                 "sway")


def read_jpeg_comment(path: str) -> Optional[str]:
    """Read the first COM (0xFFFE) segment of a JPEG without decoding it."""
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"\xff\xd8":
                return None
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    return None
                code = marker[1]
                if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
                    continue
                if code == 0xDA:  # start of scan — no COM found
                    return None
                (seglen,) = struct.unpack(">H", f.read(2))
                data = f.read(seglen - 2)
                if code == 0xFE:  # COM
                    return data.decode("utf-8", errors="replace")
    except Exception as e:
        logger.debug("COM read failed for %s: %s", path, e)
    return None


def exiftool_comments(paths: List[str], exiftool_path: str = "exiftool",
                      chunk: int = 200) -> Dict[str, str]:
    """Batch File:Comment extraction via exiftool subprocess (chunked, as
    the reference does on Windows). Returns {abspath: comment}."""
    out: Dict[str, str] = {}
    for i in range(0, len(paths), chunk):
        batch = paths[i:i + chunk]
        try:
            res = subprocess.run(
                [exiftool_path, "-G0", "-j", "-File:Comment", *batch],
                capture_output=True, text=True, timeout=600)
            for rec in json.loads(res.stdout or "[]"):
                src = rec.get("SourceFile")
                com = rec.get("File:Comment") or rec.get("Comment")
                if src and com:
                    out[os.path.abspath(src)] = str(com)
        except Exception as e:
            logger.warning("exiftool batch failed: %s", e)
    return out


def get_comments(paths: List[str],
                 exiftool_path: Optional[str] = None) -> Dict[str, str]:
    """Comment per image: exiftool when present, built-in COM reader else."""
    if exiftool_path and shutil.which(exiftool_path):
        got = exiftool_comments(paths, exiftool_path)
        if got:
            return got
    out = {}
    for p in paths:
        c = read_jpeg_comment(p)
        if c:
            out[os.path.abspath(p)] = c
    return out


def parse_telemetry(comment: str) -> Dict[str, float]:
    """Regex-parse the GAVIA telemetry block exactly as the reference does
    (Example_data_preparation.py:309-348): floats default to NaN when
    absent; ``<lat>DDMM.MMMM[NS]</lat>`` / ``<lon>DDDMM.MMMM[EW]</lon>``
    carry a trailing hemisphere letter (lat: 2 degree digits, lon: 3).
    The fixed-digit slicing is kept deliberately (NOT unified with
    geodesy.ddmm_to_decimal, which floors v/100): the two only agree on
    well-formed strings, and this path's contract is byte-for-byte
    reference parity including malformed-input behavior."""
    import numpy as np

    vals: Dict[str, float] = {}
    for name in _FLOAT_FIELDS:
        m = re.search(f"<{name}>(.*)</{name}>", comment)
        try:
            vals[name] = float(m.group(1)) if m else float("nan")
        except ValueError:
            vals[name] = float("nan")

    lat = lon = float("nan")
    lat_m = re.search("<lat>(.*)</lat>", comment)
    lon_m = re.search("<lon>(.*)</lon>", comment)
    if lat_m and lon_m:
        lat_str, lon_str = lat_m.group(1), lon_m.group(1)
        try:
            signlat = -1 if lat_str.strip().upper().endswith("S") else 1
            lat = signlat * (float(lat_str[:2])
                             + float(lat_str[2:len(lat_str) - 1]) / 60.0)
            signlon = -1 if lon_str.strip().upper().endswith("W") else 1
            lon = signlon * (float(lon_str[:3])
                             + float(lon_str[3:len(lon_str) - 1]) / 60.0)
        except (ValueError, IndexError):
            lat = lon = float("nan")
    vals["lat"] = lat
    vals["lon"] = lon
    return vals
