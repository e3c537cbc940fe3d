"""Geodesy: WGS84 lat/lon -> UTM, and AUV EXIF coordinate parsing (port
of ``multimodal_auv_tpu/dataprep/geodesy.py``).

Replaces the reference's pyproj dependency (its Examples/
Example_data_preparation.py:352-366): zone = floor((lon+180)/6)+1, then a Transverse-Mercator forward
projection (standard Snyder/USGS series, sub-meter agreement with PROJ over
UTM's validity range).

Also hosts the ddmm.mmm[NSEW] -> decimal-degrees conversion used when
parsing GAVIA EXIF comments (Example_data_preparation.py:336-348).
"""
from __future__ import annotations

import math
from typing import Tuple

# WGS84
_A = 6378137.0
_E2 = 0.00669438  # first eccentricity squared
_E4 = _E2 * _E2
_E6 = _E4 * _E2
_EP2 = _E2 / (1.0 - _E2)
_K0 = 0.9996

_M1 = 1.0 - _E2 / 4 - 3 * _E4 / 64 - 5 * _E6 / 256
_M2 = 3 * _E2 / 8 + 3 * _E4 / 32 + 45 * _E6 / 1024
_M3 = 15 * _E4 / 256 + 45 * _E6 / 1024
_M4 = 35 * _E6 / 3072

_ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def utm_zone(lon: float) -> int:
    """floor((lon+180)/6)+1 — the reference's auto-zone formula."""
    return int((lon + 180.0) // 6.0) + 1


def utm_zone_letter(lat: float) -> str:
    if -80.0 <= lat <= 84.0:
        return _ZONE_LETTERS[int((lat + 80.0) // 8.0)]
    return ""


def latlon_to_utm(lat: float, lon: float,
                  force_zone: int | None = None) -> Tuple[float, float, int, str]:
    """Returns (easting, northing, zone_number, zone_letter)."""
    if not (-80.0 <= lat <= 84.0):
        raise ValueError(f"latitude {lat} outside UTM range")
    zone = force_zone if force_zone is not None else utm_zone(lon)
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)

    phi = math.radians(lat)
    lam = math.radians(lon)
    sphi, cphi = math.sin(phi), math.cos(phi)
    tphi = math.tan(phi)

    n = _A / math.sqrt(1.0 - _E2 * sphi * sphi)
    t = tphi * tphi
    c = _EP2 * cphi * cphi
    a = cphi * (lam - lon0)

    m = _A * (_M1 * phi
              - _M2 * math.sin(2 * phi)
              + _M3 * math.sin(4 * phi)
              - _M4 * math.sin(6 * phi))

    a2, a3 = a * a, a * a * a
    a4, a5, a6 = a2 * a2, a2 * a3, a3 * a3
    easting = _K0 * n * (a
                         + (1 - t + c) * a3 / 6.0
                         + (5 - 18 * t + t * t + 72 * c - 58 * _EP2) * a5 / 120.0
                         ) + 500000.0
    northing = _K0 * (m + n * tphi * (a2 / 2.0
                                      + (5 - t + 9 * c + 4 * c * c) * a4 / 24.0
                                      + (61 - 58 * t + t * t + 600 * c
                                         - 330 * _EP2) * a6 / 720.0))
    if lat < 0:
        northing += 10000000.0
    return easting, northing, zone, utm_zone_letter(lat)


def ddmm_to_decimal(value: float | str, hemisphere: str) -> float:
    """GAVIA-style ddmm.mmmm -> decimal degrees; S/W negative. General
    helper using floor(v/100) for the degree digits — note that
    exif.parse_telemetry deliberately does NOT call this: it reproduces
    the reference's fixed-digit string slicing byte-for-byte
    (Example_data_preparation.py:336-348, lat 2 / lon 3 degree digits),
    which only agrees with this helper on well-formed strings."""
    v = float(value)
    degrees = math.floor(v / 100.0)
    minutes = v - degrees * 100.0
    dec = degrees + minutes / 60.0
    if hemisphere.upper() in ("S", "W"):
        dec = -dec
    return dec
