"""GeoTIFF windowed reader and writer (port of
``multimodal_auv_tpu/dataprep/geotiff.py``), the rasterio/GDAL replacement.

The reference extracts georeferenced patches with rasterio window reads
(its data_preparation/geospatial.py:34-135). This module implements:

  * a classic-TIFF/BigTIFF IFD parser (tags, incl. GeoTIFF ModelPixelScale
    33550 / ModelTiepoint 33922 / ModelTransformation 34264 / GDAL_NODATA
    42113),
  * windowed decoding of stripped and tiled rasters (compression: none,
    deflate/zlib, PackBits, LZW; horizontal-differencing predictor),
    touching only the strips/tiles that intersect the window,
  * an optional one-time pack to a .npy memmap ("pre-pack"), after which
    every windowed read is a pure numpy slice (the fast path for
    patch-extraction sweeps).

LZW decodes in the port's C++ host runtime (``native/``, built at first
use) when it is available, else in pure Python (``_lzw_decode``), as in the
JAX package.
"""
from __future__ import annotations

import logging
import math
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# TIFF tag ids
_T_WIDTH = 256
_T_HEIGHT = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SPP = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_COUNTS = 279
_T_PLANAR = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_HEIGHT = 323
_T_TILE_OFFSETS = 324
_T_TILE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_MODEL_PIXEL_SCALE = 33550
_T_MODEL_TIEPOINT = 33922
_T_MODEL_TRANSFORM = 34264
_T_GDAL_NODATA = 42113

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}

# Robustness caps: a corrupt/malicious header must degrade to a clean
# TiffError (a skipped sample in a sweep), never an unbounded allocation or
# an uncaught struct/index error (rasterio's robustness role,
# geospatial.py:61-98).
_MAX_IFD_ENTRIES = 4096
_MAX_TAG_BYTES = 1 << 26       # 64 MiB per tag payload
_MAX_DIM = 1 << 20             # 1M pixels per axis
_MAX_BLOCK_BYTES = 1 << 31     # 2 GiB decoded per strip/tile

_ZSTD_TLS = threading.local()  # per-thread lazy ZstdDecompressor


class TiffError(ValueError):
    """Malformed, truncated, or unsupported TIFF — safe to skip."""


def _dtype_of(bits: int, fmt: int) -> np.dtype:
    try:
        if fmt == 3:
            return np.dtype({32: np.float32, 64: np.float64}[bits])
        if fmt == 2:
            return np.dtype({8: np.int8, 16: np.int16, 32: np.int32}[bits])
        return np.dtype({8: np.uint8, 16: np.uint16, 32: np.uint32}[bits])
    except KeyError:
        raise TiffError(f"unsupported sample format {fmt}/{bits}bit") from None


def _unpackbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (MSB-first, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    dict_init = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(dict_init)
    bitpos = 0
    nbits = 9
    prev: Optional[bytes] = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits and len(out) < expected:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(data[byte_idx:byte_idx + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == CLEAR:
            table = list(dict_init)
            nbits = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            if code >= len(table):
                break  # corrupt stream: first code must be a literal
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # "early change": the decoder's table lags the encoder's by one
        # entry, so widen one entry sooner (libtiff-compatible: libtiff's
        # encoder switches when ITS next free code reaches 1<<nbits, i.e.
        # decoder table size (1<<nbits)-1 — verified byte-for-byte against
        # a PIL/libtiff-written file; -2 corrupted every real LZW raster
        # at the 9->10 bit switch, table entry 510).
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


@dataclass
class GeoTiff:
    """Minimal single-image GeoTIFF with windowed reads."""

    path: str
    width: int = 0
    height: int = 0
    count: int = 1  # samples per pixel (bands)
    dtype: np.dtype = field(default_factory=lambda: np.dtype(np.uint8))
    compression: int = 1
    predictor: int = 1
    planar: int = 1
    byteorder: str = "<"  # struct-style '<' (II) or '>' (MM)
    _mm: Any = None  # decoded-raster memmap attached by to_memmap()
    rows_per_strip: int = 0
    tile_width: int = 0
    tile_height: int = 0
    _offsets: np.ndarray = None
    _counts: np.ndarray = None
    # affine geotransform (GDAL order): (x0, dx, rxy, y0, ryx, dy)
    transform: Tuple[float, float, float, float, float, float] = (
        0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    nodata: Optional[float] = None

    # ------------------------------------------------------------------
    @classmethod
    def open(cls, path: str) -> "GeoTiff":
        g = cls(path=path)
        try:
            with open(path, "rb") as f:
                header = f.read(16)
                if len(header) < 8:
                    raise TiffError(f"{path}: truncated header")
                if header[:2] == b"II":
                    end = "<"
                elif header[:2] == b"MM":
                    end = ">"
                else:
                    raise TiffError(f"{path}: not a TIFF")
                g.byteorder = end
                magic = struct.unpack(end + "H", header[2:4])[0]
                big = magic == 43
                if magic not in (42, 43):
                    raise TiffError(f"{path}: bad TIFF magic {magic}")
                if big:
                    if len(header) < 16:
                        raise TiffError(f"{path}: truncated BigTIFF header")
                    off = struct.unpack(end + "Q", header[8:16])[0]
                else:
                    off = struct.unpack(end + "I", header[4:8])[0]
                tags = g._read_ifd(f, off, end, big)
            g._apply_tags(tags)
        except TiffError:
            raise
        except (struct.error, KeyError, IndexError, OverflowError,
                ValueError) as e:
            # a corrupt file must fail cleanly, never crash a sweep
            raise TiffError(f"{path}: malformed TIFF ({e})") from e
        return g

    def _read_ifd(self, f, off: int, end: str, big: bool) -> Dict[int, np.ndarray]:
        f.seek(off)
        if big:
            n = struct.unpack(end + "Q", f.read(8))[0]
            entry_size, cnt_fmt, val_len = 20, "Q", 8
        else:
            n = struct.unpack(end + "H", f.read(2))[0]
            entry_size, cnt_fmt, val_len = 12, "I", 4
        if n > _MAX_IFD_ENTRIES:
            raise TiffError(f"{self.path}: IFD claims {n} entries")
        raw = f.read(entry_size * n)
        if len(raw) < entry_size * n:
            raise TiffError(f"{self.path}: truncated IFD "
                            f"({len(raw)}/{entry_size * n} bytes)")
        tags: Dict[int, np.ndarray] = {}
        fmt_map = {1: "B", 2: "c", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i",
                   11: "f", 12: "d", 16: "Q", 17: "q"}
        for i in range(n):
            e = raw[i * entry_size:(i + 1) * entry_size]
            tag, typ = struct.unpack(end + "HH", e[:4])
            cnt = struct.unpack(end + cnt_fmt, e[4:4 + (8 if big else 4)])[0]
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size > _MAX_TAG_BYTES:
                raise TiffError(f"{self.path}: tag {tag} claims {size} bytes")
            voff = 4 + (8 if big else 4)
            if size <= val_len:
                data = e[voff:voff + size]
            else:
                ptr = struct.unpack(end + cnt_fmt, e[voff:voff + (8 if big else 4)])[0]
                pos = f.tell()
                f.seek(ptr)
                data = f.read(size)
                f.seek(pos)
                if len(data) < size:
                    raise TiffError(f"{self.path}: tag {tag} data truncated")
            if typ in (5, 10):  # rationals
                ints = struct.unpack(end + ("I" if typ == 5 else "i") * (cnt * 2), data)
                vals = np.asarray([ints[2 * i] / max(ints[2 * i + 1], 1)
                                   for i in range(cnt)])
            elif typ == 2:
                vals = np.frombuffer(data, np.uint8)
            elif typ in fmt_map:
                vals = np.asarray(struct.unpack(end + fmt_map[typ] * cnt, data))
            else:
                continue
            tags[tag] = vals
        return tags

    def _apply_tags(self, tags: Dict[int, np.ndarray]):
        def get1(t, default=None):
            v = tags.get(t)
            return default if v is None or len(v) == 0 else v[0]

        w, h = get1(_T_WIDTH), get1(_T_HEIGHT)
        if w is None or h is None:
            raise TiffError(f"{self.path}: missing width/height tags")
        self.width, self.height = int(w), int(h)
        if not (0 < self.width <= _MAX_DIM and 0 < self.height <= _MAX_DIM):
            raise TiffError(f"{self.path}: implausible dimensions "
                            f"{self.width}x{self.height}")
        self.count = int(get1(_T_SPP, 1))
        if not 0 < self.count <= 1024:
            raise TiffError(f"{self.path}: implausible band count {self.count}")
        bits = int(tags.get(_T_BITS, np.asarray([8]))[0])
        fmt = int(tags.get(_T_SAMPLE_FORMAT, np.asarray([1]))[0])
        self.dtype = _dtype_of(bits, fmt)
        self.compression = int(get1(_T_COMPRESSION, 1))
        self.predictor = int(get1(_T_PREDICTOR, 1))
        if self.predictor not in (1, 2, 3):
            # an unknown predictor silently ignored would decode to
            # garbage pixels, not an error — refuse instead
            raise TiffError(f"{self.path}: TIFF predictor "
                            f"{self.predictor} unsupported")
        if self.predictor == 3 and self.dtype.kind != "f":
            raise TiffError(f"{self.path}: predictor 3 (floating-point "
                            f"differencing) on non-float samples")
        self.planar = int(get1(_T_PLANAR, 1))
        if self.planar not in (1, 2):
            raise TiffError(f"{self.path}: PlanarConfiguration "
                            f"{self.planar} invalid (must be 1 or 2)")
        if _T_TILE_OFFSETS in tags:
            tw, th = get1(_T_TILE_WIDTH), get1(_T_TILE_HEIGHT)
            if tw is None or th is None or _T_TILE_COUNTS not in tags:
                raise TiffError(f"{self.path}: incomplete tile tags")
            self.tile_width = int(tw)
            self.tile_height = int(th)
            if not (0 < self.tile_width <= _MAX_DIM
                    and 0 < self.tile_height <= _MAX_DIM):
                raise TiffError(f"{self.path}: implausible tile size")
            self._offsets = tags[_T_TILE_OFFSETS].astype(np.int64)
            self._counts = tags[_T_TILE_COUNTS].astype(np.int64)
        else:
            if _T_STRIP_OFFSETS not in tags or _T_STRIP_COUNTS not in tags:
                raise TiffError(f"{self.path}: missing strip offset/count tags")
            self.rows_per_strip = int(get1(_T_ROWS_PER_STRIP, self.height))
            if self.rows_per_strip <= 0:
                raise TiffError(f"{self.path}: bad RowsPerStrip")
            self._offsets = tags[_T_STRIP_OFFSETS].astype(np.int64)
            self._counts = tags[_T_STRIP_COUNTS].astype(np.int64)
        if len(self._offsets) != len(self._counts) or len(self._offsets) == 0:
            raise TiffError(f"{self.path}: strip/tile offsets vs counts "
                            f"mismatch ({len(self._offsets)} vs "
                            f"{len(self._counts)})")
        if self.planar == 2:
            # plane-major block layout: spp x blocks-per-plane entries
            if self.tile_width:
                per_plane = (math.ceil(self.width / self.tile_width)
                             * math.ceil(self.height / self.tile_height))
            else:
                per_plane = (self.height - 1) // self.rows_per_strip + 1
            if len(self._offsets) != self.count * per_plane:
                raise TiffError(
                    f"{self.path}: PlanarConfiguration 2 expects "
                    f"{self.count} x {per_plane} blocks, found "
                    f"{len(self._offsets)}")

        if _T_MODEL_TRANSFORM in tags and len(tags[_T_MODEL_TRANSFORM]) >= 16:
            m = tags[_T_MODEL_TRANSFORM]
            self.transform = (float(m[3]), float(m[0]), float(m[1]),
                              float(m[7]), float(m[4]), float(m[5]))
        elif _T_MODEL_PIXEL_SCALE in tags and _T_MODEL_TIEPOINT in tags:
            sx, sy = float(tags[_T_MODEL_PIXEL_SCALE][0]), float(
                tags[_T_MODEL_PIXEL_SCALE][1])
            tp = tags[_T_MODEL_TIEPOINT]
            # tiepoint: (i, j, k, x, y, z) — raster (i,j) maps to model (x,y)
            i0, j0, x0, y0 = float(tp[0]), float(tp[1]), float(tp[3]), float(tp[4])
            self.transform = (x0 - i0 * sx, sx, 0.0, y0 + j0 * sy, 0.0, -sy)
        if _T_GDAL_NODATA in tags:
            try:
                s = bytes(tags[_T_GDAL_NODATA].tobytes()).split(b"\0")[0]
                self.nodata = float(s)
            except Exception:
                self.nodata = None

    # ------------------------------------------------------------------
    @property
    def res(self) -> Tuple[float, float]:
        """(pixel_width, pixel_height) — geospatial.py:9-31 parity
        (transform[1], |transform[5]| in GDAL order)."""
        return self.transform[1], abs(self.transform[5])

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        x0, dx, _, y0, _, dy = self.transform
        x1 = x0 + dx * self.width
        y1 = y0 + dy * self.height
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    def index(self, x: float, y: float) -> Tuple[int, int]:
        """Model coords -> (row, col). floor, not int() truncation:
        rasterio's index() (the parity target) maps a point up to one
        pixel west/north of the origin to -1, while truncation would fold
        it onto row/col 0 — shifting every just-outside patch window by a
        pixel."""
        x0, dx, _, y0, _, dy = self.transform
        col = math.floor((x - x0) / dx)
        row = math.floor((y - y0) / dy)
        return row, col

    # ------------------------------------------------------------------
    def _decode_block(self, idx: int, nbytes_expected: int,
                      row_nvals: int = 0) -> np.ndarray:
        if nbytes_expected > _MAX_BLOCK_BYTES:
            raise TiffError(f"{self.path}: block {idx} claims "
                            f"{nbytes_expected} decoded bytes")
        if not 0 <= idx < len(self._offsets):
            raise TiffError(f"{self.path}: block index {idx} out of range "
                            f"({len(self._offsets)} blocks)")
        count = int(self._counts[idx])
        if count < 0 or int(self._offsets[idx]) < 0:
            raise TiffError(f"{self.path}: negative strip offset/count")
        with open(self.path, "rb") as f:
            f.seek(int(self._offsets[idx]))
            raw = f.read(min(count, _MAX_BLOCK_BYTES))
        if self.compression == 1:
            data = raw
        elif self.compression in (8, 32946):  # deflate
            try:
                # bound the output like the zstd branch: a lying stream
                # (up to ~1032:1 expansion) must not balloon memory past
                # the block's declared size before the length check runs
                dobj = zlib.decompressobj()
                data = dobj.decompress(raw, nbytes_expected)
            except zlib.error as e:
                raise TiffError(f"{self.path}: corrupt deflate block {idx} "
                                f"({e})") from e
            if len(data) < nbytes_expected and not dobj.eof:
                # short output AND no end-of-stream marker = truncated
                # stream (partial download/copy) — reject like
                # zlib.decompress did, rather than zero-padding corrupt
                # data downstream. (A bound-hit leaves len == expected; a
                # COMPLETE short stream has eof set and pads as before.)
                raise TiffError(f"{self.path}: truncated deflate block "
                                f"{idx}")
        elif self.compression == 5:
            data = _native_or_py_lzw(raw, nbytes_expected)
        elif self.compression == 32773:
            data = _unpackbits_decode(raw, nbytes_expected)
        elif self.compression == 50000:  # ZSTD (GDAL/libtiff modern default)
            try:
                import zstandard
            except ImportError as e:
                raise NotImplementedError(
                    f"{self.path}: zstd-compressed TIFF needs the "
                    f"'zstandard' module") from e
            try:
                # each strip/tile is an independent zstd frame; cap the
                # output at the expected block size (a lying frame must
                # not balloon memory). One decompressor per THREAD — the
                # windowed sweep decodes thousands of blocks and context
                # construction is not free, but zstandard documents
                # ZstdDecompressor instances as NOT thread safe (one
                # ZSTD_DCtx each), and this repo's loaders do use thread
                # pools
                dctx = getattr(_ZSTD_TLS, "dctx", None)
                if dctx is None:
                    dctx = _ZSTD_TLS.dctx = zstandard.ZstdDecompressor()
                data = dctx.decompress(
                    raw, max_output_size=nbytes_expected)
            except zstandard.ZstdError as e:
                raise TiffError(f"{self.path}: corrupt zstd block {idx} "
                                f"({e})") from e
        else:
            raise NotImplementedError(
                f"{self.path}: TIFF compression {self.compression} unsupported")
        if len(data) < nbytes_expected:
            # truncated strip: pad with zeros (degrade, don't crash)
            data = data + b"\0" * (nbytes_expected - len(data))
        if self.predictor == 3:
            data = self._fp3_undo(data[:nbytes_expected], row_nvals)
        # decode with the FILE's byte order, hand native order downstream:
        # a big-endian ('MM') raster's 16/32-bit samples read byte-swapped
        # through a native-order frombuffer (59k/60k wrong values on a
        # 'MM' uint16 fixture), and predictor math / consumers assume
        # native order.
        file_dt = self.dtype.newbyteorder(self.byteorder)
        arr = np.frombuffer(data, file_dt, count=nbytes_expected //
                            self.dtype.itemsize)
        return arr.astype(self.dtype, copy=False)

    def _fp3_undo(self, data: bytes, nvals_row: int) -> bytes:
        """Reverse TIFF predictor 3 (floating-point horizontal
        differencing, libtiff tif_predict.c::fpAcc) on one block's bytes:
        per scanline, byte-wise accumulation with stride = samples/pixel
        across the whole row (crossing byte-plane boundaries), then
        reassemble each value from its byte planes (stored
        most-significant-first) into the file's byte order. GDAL writes
        PREDICTOR=3 for compressed float rasters — exactly the survey
        bathymetry case."""
        bps = self.dtype.itemsize
        stride = 1 if self.planar == 2 else self.count
        row_bytes = nvals_row * bps
        a = np.frombuffer(data, np.uint8)
        if row_bytes == 0 or len(a) % row_bytes:
            raise TiffError(f"{self.path}: predictor-3 block is not a "
                            f"whole number of rows")
        rows = a.reshape(-1, row_bytes)
        acc = rows.reshape(rows.shape[0], -1, stride).cumsum(
            axis=1, dtype=np.int64).astype(np.uint8)
        planes = acc.reshape(rows.shape[0], bps, nvals_row)
        if self.byteorder == ">":
            ordered = planes.transpose(0, 2, 1)          # MSB-first file
        else:
            ordered = planes[:, ::-1, :].transpose(0, 2, 1)  # LSB-first
        return np.ascontiguousarray(ordered).tobytes()

    def _undo_predictor(self, block: np.ndarray) -> np.ndarray:
        """Horizontal differencing: per row, per channel, cumulative sum
        along the column axis. block: (rows, cols, spp)."""
        if self.predictor == 2:
            block = block.cumsum(axis=1, dtype=np.int64).astype(self.dtype)
        return block

    def read_window(self, row_off: int, col_off: int, h: int, w: int,
                    band: int = 0, boundless: bool = False,
                    fill_value: float = 0.0) -> np.ndarray:
        """Decode only the strips/tiles intersecting [row_off:row_off+h,
        col_off:col_off+w]; returns (h, w) of self.dtype for one band.

        PlanarConfiguration 2 (TIFF 6.0 §"Planar Configuration"): each
        strip/tile stores ONE sample plane, blocks ordered plane-major
        (all of band 0, then band 1, ...). Windowed reads decode only the
        requested band's plane — 1/spp the IO of the chunky layout."""
        if not 0 <= band < self.count:
            raise ValueError(f"band {band} out of range ({self.count})")
        out = np.full((h, w), fill_value, self.dtype)

        r0 = max(row_off, 0)
        c0 = max(col_off, 0)
        r1 = min(row_off + h, self.height)
        c1 = min(col_off + w, self.width)
        if r1 <= r0 or c1 <= c0:
            if not boundless:
                raise ValueError("window does not intersect raster")
            return out

        if self._mm is not None:
            # pre-packed fast path (to_memmap): a pure slice, no decode
            out[r0 - row_off:r1 - row_off, c0 - col_off:c1 - col_off] = \
                self._mm[r0:r1, c0:c1, band]
            return out

        planar2 = self.planar == 2
        bspp = 1 if planar2 else self.count   # samples stored per block
        bband = 0 if planar2 else band        # channel index within a block
        if self.tile_width:
            tw, th = self.tile_width, self.tile_height
            tiles_across = math.ceil(self.width / tw)
            tiles_down = math.ceil(self.height / th)
            plane_base = band * tiles_across * tiles_down if planar2 else 0
            for trow in range(r0 // th, (r1 - 1) // th + 1):
                for tcol in range(c0 // tw, (c1 - 1) // tw + 1):
                    idx = plane_base + trow * tiles_across + tcol
                    nbytes = tw * th * bspp * self.dtype.itemsize
                    block = self._decode_block(
                        idx, nbytes, row_nvals=tw * bspp).reshape(
                        th, tw, bspp)
                    block = self._undo_predictor(block)
                    gr0, gc0 = trow * th, tcol * tw
                    sr0, sc0 = max(r0, gr0), max(c0, gc0)
                    sr1, sc1 = min(r1, gr0 + th), min(c1, gc0 + tw)
                    out[sr0 - row_off:sr1 - row_off,
                        sc0 - col_off:sc1 - col_off] = \
                        block[sr0 - gr0:sr1 - gr0, sc0 - gc0:sc1 - gc0, bband]
        else:
            rps = self.rows_per_strip
            strips_per_plane = (self.height - 1) // rps + 1
            plane_base = band * strips_per_plane if planar2 else 0
            for strip in range(r0 // rps, (r1 - 1) // rps + 1):
                srow0 = strip * rps
                rows = min(rps, self.height - srow0)
                nbytes = rows * self.width * bspp * self.dtype.itemsize
                block = self._decode_block(
                    plane_base + strip, nbytes,
                    row_nvals=self.width * bspp).reshape(
                    rows, self.width, bspp)
                block = self._undo_predictor(block)
                sr0, sr1 = max(r0, srow0), min(r1, srow0 + rows)
                out[sr0 - row_off:sr1 - row_off, c0 - col_off:c1 - col_off] = \
                    block[sr0 - srow0:sr1 - srow0, c0:c1, bband]
        return out

    def read(self, band: int = 0) -> np.ndarray:
        return self.read_window(0, 0, self.height, self.width, band=band,
                                boundless=True)

    # ------------------------------------------------------------------
    def to_memmap(self, cache_dir: str) -> np.memmap:
        """One-time pre-pack to a .npy memmap: subsequent windowed reads
        (``read_window``) become pure slices (the patch-sweep fast path).
        The cache key hashes the FULL path plus mtime_ns and size —
        basename+mtime alone collided for same-named rasters in different
        survey directories sharing a cache_dir (one silently returned the
        other's pixels)."""
        import hashlib

        os.makedirs(cache_dir, exist_ok=True)
        st = os.stat(self.path)
        tag = hashlib.sha1(os.path.abspath(self.path).encode()).hexdigest()[:12]
        key = (f"{os.path.basename(self.path)}_{tag}"
               f"_{st.st_mtime_ns}_{st.st_size}")
        npy = os.path.join(cache_dir, key + ".npy")
        if not os.path.exists(npy):
            full = np.stack([self.read(b) for b in range(self.count)], axis=-1)
            np.save(npy, full)
        self._mm = np.load(npy, mmap_mode="r")
        return self._mm


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, ClearCode 256, EOI 257) with libtiff's
    early change: the code width grows when the next free code reaches
    1 << width, and the table is cleared before code 4094."""
    clear, eoi = 256, 257
    table: Dict[Tuple[int, int], int] = {}
    next_code, nbits = 258, 9
    out = bytearray()
    acc = accn = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, accn
        acc = (acc << width) | code
        accn += width
        while accn >= 8:
            accn -= 8
            out.append((acc >> accn) & 0xFF)
        acc &= (1 << accn) - 1

    emit(clear, nbits)
    w = -1
    for ch in data:
        if w < 0:
            w = ch
            continue
        code = table.get((w, ch))
        if code is not None:
            w = code
            continue
        emit(w, nbits)
        table[(w, ch)] = next_code
        next_code += 1
        if next_code == (1 << nbits):
            nbits += 1
        if next_code >= 4094:
            emit(clear, nbits)
            table.clear()
            next_code, nbits = 258, 9
        w = ch
    if w >= 0:
        emit(w, nbits)
    emit(eoi, nbits)
    if accn:
        out.append((acc << (8 - accn)) & 0xFF)
    return bytes(out)


def _native_or_py_lzw(raw: bytes, expected: int) -> bytes:
    """LZW through the C++ host runtime where it is built, else (and for a
    stream it refuses as corrupt, as the JAX package does) in Python."""
    from multimodal_auv_torch import native

    if native.lib is not None:
        try:
            return native.lib.lzw_decode(raw, expected)
        except ValueError:
            pass
    return _lzw_decode(raw, expected)


def get_pixel_resolution(path: str) -> Tuple[float, float]:
    """geospatial.py:9-31 parity: (x_res, |y_res|)."""
    return GeoTiff.open(path).res


def extract_grid_patch(
    tiff_path_or_obj, easting: float, northing: float,
    window_size_meters: float,
) -> Tuple[Optional[np.ndarray], Optional[Tuple[float, float]], str]:
    """geospatial.py:34-135 parity: centered window in meters around
    (easting, northing), clipped to raster bounds, nodata/empty checked.

    Returns (data[bands,h,w] or None, actual_center or None, kind) with kind
    'Bathy' if the filename contains 'Bathy' else 'SSS'."""
    g = (tiff_path_or_obj if isinstance(tiff_path_or_obj, GeoTiff)
         else GeoTiff.open(tiff_path_or_obj))
    kind = "Bathy" if "Bathy" in os.path.basename(g.path) else "SSS"

    xres, yres = g.res
    half_w = max(int(round(window_size_meters / xres / 2)), 1)
    half_h = max(int(round(window_size_meters / yres / 2)), 1)
    row, col = g.index(easting, northing)

    r0, r1 = row - half_h, row + half_h
    c0, c1 = col - half_w, col + half_w
    # intersection with raster bounds (rasterio window.intersection parity)
    ir0, ir1 = max(r0, 0), min(r1, g.height)
    ic0, ic1 = max(c0, 0), min(c1, g.width)
    if ir1 <= ir0 or ic1 <= ic0:
        logger.debug("patch at (%.1f, %.1f) outside %s", easting, northing, g.path)
        return None, None, kind

    bands = []
    for b in range(g.count):
        bands.append(g.read_window(ir0, ic0, ir1 - ir0, ic1 - ic0, band=b,
                                   boundless=True))
    data = np.stack(bands, axis=0)

    if g.nodata is not None and np.all(data == g.nodata):
        return None, None, kind
    if not np.any(np.isfinite(data.astype(np.float64))) or data.size == 0:
        return None, None, kind

    x0, dx, _, y0, _, dy = g.transform
    center = (x0 + dx * (ic0 + ic1) / 2.0, y0 + dy * (ir0 + ir1) / 2.0)
    return data, center, kind


def write_geotiff(path: str, data: np.ndarray,
                  transform: Tuple[float, float, float, float, float, float],
                  nodata: Optional[float] = None, planar: int = 1,
                  rows_per_strip: Optional[int] = None,
                  tile: Optional[Tuple[int, int]] = None,
                  compression: str = "none", predictor: int = 1,
                  bigtiff: bool = False,
                  transform_matrix: bool = False) -> str:
    """Minimal GeoTIFF writer (test fixtures + patch outputs).
    data: (H, W) or (H, W, C).

    ``planar=2`` writes PlanarConfiguration-2 (plane-major blocks: all of
    band 0's, then band 1's, ...); ``rows_per_strip`` splits each plane
    into multiple strips (default: one strip per plane); ``tile=(tw, th)``
    writes a TILED raster instead of strips (tiles zero-padded to full
    size at the right/bottom edges, per TIFF 6.0); ``compression`` is
    'none', 'deflate' (tag 8, zlib per block), 'lzw' (tag 5, libtiff's
    LZW per block; the port's addition, the JAX package's writer has no
    LZW) or 'zstd' (tag 50000, one zstd frame per block — libtiff/GDAL
    layout); ``predictor`` is 1
    (none), 2 (integer horizontal differencing) or 3 (floating-point
    byte-plane differencing — GDAL's PREDICTOR=3 for float rasters);
    ``bigtiff=True`` writes the BigTIFF container (magic 43, 8-byte
    offsets, 20-byte IFD entries, LONG8 block tables — the >4 GB mosaic
    format GDAL switches to automatically); ``transform_matrix=True``
    encodes the geotransform as a ModelTransformation tag (34264, the
    4x4 matrix some GDAL outputs carry) instead of
    PixelScale+Tiepoint."""
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    dt = data.dtype
    fmt = 3 if dt.kind == "f" else (2 if dt.kind == "i" else 1)
    bits = dt.itemsize * 8
    if planar not in (1, 2):
        raise ValueError(f"planar must be 1 or 2, got {planar}")
    if tile is not None and rows_per_strip is not None:
        raise ValueError("tile and rows_per_strip are mutually exclusive")
    if compression == "none":
        comp_tag, _pack = 1, lambda b: b
    elif compression == "deflate":
        comp_tag, _pack = 8, zlib.compress
    elif compression == "lzw":
        comp_tag, _pack = 5, _lzw_encode
    elif compression == "zstd":
        import zstandard
        _cctx = zstandard.ZstdCompressor()
        comp_tag, _pack = 50000, _cctx.compress
    else:
        raise ValueError(f"compression must be 'none', 'deflate', 'lzw' "
                         f"or 'zstd', got {compression!r}")
    if predictor not in (1, 2, 3):
        raise ValueError(f"predictor must be 1, 2 or 3, got {predictor}")
    if predictor == 3 and dt.kind != "f":
        raise ValueError("predictor 3 is floating-point differencing; "
                         f"data is {dt}")
    if predictor == 2 and dt.kind not in ("u", "i"):
        raise ValueError("predictor 2 is integer differencing; "
                         f"data is {dt}")

    def _blocks_of(plane):  # plane: (H, W, bspp) slab -> list of arrays
        if tile is not None:
            tw, th = tile
            out = []
            for trow in range(math.ceil(h / th)):
                for tcol in range(math.ceil(w / tw)):
                    blk = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[trow * th:(trow + 1) * th,
                                 tcol * tw:(tcol + 1) * tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    out.append(blk)
            return out
        rps = int(rows_per_strip or h)
        return [np.ascontiguousarray(plane[s * rps:(s + 1) * rps])
                for s in range((h - 1) // rps + 1)]

    def _predict(arr):  # arr: (rows, cols, bspp) -> encoded bytes
        if predictor == 2:
            d = arr.astype(np.int64)
            d[:, 1:, :] -= arr[:, :-1, :]
            return d.astype(dt).tobytes()  # modular wrap, matches cumsum undo
        if predictor == 3:
            # libtiff fpDiff: per row, split values into byte planes
            # (most-significant first), then byte-diff with stride = spp
            r, cols, bspp = arr.shape
            nvals, bps = cols * bspp, dt.itemsize
            vb = np.frombuffer(np.ascontiguousarray(arr).tobytes(),
                               np.uint8).reshape(r, nvals, bps)
            planes = np.ascontiguousarray(
                vb[:, :, ::-1].transpose(0, 2, 1))    # [row, MSB-plane, val]
            flat = planes.reshape(r, -1, bspp).astype(np.int64)
            d = flat.copy()
            d[:, 1:, :] -= flat[:, :-1, :]
            return d.astype(np.uint8).tobytes()
        return arr.tobytes()

    rps = int(rows_per_strip or h)
    if planar == 2:
        raw_blocks = [b for band in range(c)
                      for b in _blocks_of(data[:, :, band:band + 1])]
    else:
        raw_blocks = _blocks_of(data)
    blocks = [_pack(_predict(b)) for b in raw_blocks]
    n_blocks = len(blocks)
    hdr_len = 16 if bigtiff else 8
    block_offs = []
    pos = hdr_len  # header + blocks... + IFD
    for sb in blocks:
        block_offs.append(pos)
        pos += len(sb)
    payload = b"".join(blocks)
    strip_offset = hdr_len
    ifd_offset = strip_offset + len(payload)

    entries = []

    def entry(tag, typ, cnt, val_bytes):
        entries.append((tag, typ, cnt, val_bytes))

    extra: List[bytes] = []
    extra_off = [0]

    def ext(data_bytes):
        pos = extra_off[0]
        extra.append(data_bytes)
        extra_off[0] += len(data_bytes)
        return pos

    def short(v):
        return struct.pack("<HH", v, 0)

    def dim_entry(tag, v):
        # TIFF allows SHORT or LONG for the dimension-like tags; >65535
        # (BigTIFF-scale mosaics) needs LONG — struct.error otherwise
        if v <= 0xFFFF:
            entry(tag, 3, 1, short(v))
        else:
            entry(tag, 4, 1, struct.pack("<I", v))

    # pointer-sized value and the block-offset array type: classic TIFF
    # writes 4-byte LONG (type 4) offsets; BigTIFF writes 8-byte LONG8
    # (type 16) offsets and 20-byte IFD entries
    val_len = 8 if bigtiff else 4
    off_type = 16 if bigtiff else 4
    off_fmt = "Q" if bigtiff else "I"

    def long_(v):
        return struct.pack("<" + off_fmt, v)

    # 9 fixed entries (width/height/bits/compression/photometric/spp/
    # sample-format/pixel-scale/tiepoint) + the block-layout entries
    # (strips: offsets/counts/rows-per-strip = 3; tiles: width/height/
    # offsets/counts = 4) + optionals
    # transform_matrix packs the geotransform into ONE tag (34264) where
    # the default uses two (PixelScale + Tiepoint)
    n_entries = (9 - (1 if transform_matrix else 0)
                 + (4 if tile is not None else 3)
                 + (1 if nodata is not None else 0)
                 + (1 if planar == 2 else 0)
                 + (1 if predictor > 1 else 0))
    if bigtiff:
        extra_base = ifd_offset + 8 + n_entries * 20 + 8
    else:
        extra_base = ifd_offset + 2 + n_entries * 12 + 4

    dim_entry(_T_WIDTH, w)
    dim_entry(_T_HEIGHT, h)
    if c * 2 <= val_len:
        bits_val = struct.pack("<" + "H" * c, *([bits] * c)).ljust(val_len,
                                                                   b"\0")
        entry(_T_BITS, 3, c, bits_val)
    else:
        entry(_T_BITS, 3, c, long_(extra_base + ext(
            struct.pack("<" + "H" * c, *([bits] * c)))))
    entry(_T_COMPRESSION, 3, 1, short(comp_tag))
    entry(_T_PHOTOMETRIC, 3, 1, short(1))
    t_off = _T_TILE_OFFSETS if tile is not None else _T_STRIP_OFFSETS
    t_cnt = _T_TILE_COUNTS if tile is not None else _T_STRIP_COUNTS
    if n_blocks == 1:
        entry(t_off, off_type, 1, long_(strip_offset))
        entry(t_cnt, off_type, 1, long_(len(payload)))
    else:
        entry(t_off, off_type, n_blocks, long_(extra_base + ext(
            struct.pack("<%d%s" % (n_blocks, off_fmt), *block_offs))))
        entry(t_cnt, off_type, n_blocks, long_(extra_base + ext(
            struct.pack("<%d%s" % (n_blocks, off_fmt),
                        *[len(sb) for sb in blocks]))))
    entry(_T_SPP, 3, 1, short(c))
    if tile is not None:
        dim_entry(_T_TILE_WIDTH, tile[0])
        dim_entry(_T_TILE_HEIGHT, tile[1])
    else:
        dim_entry(_T_ROWS_PER_STRIP, rps)
    if planar == 2:
        entry(_T_PLANAR, 3, 1, short(2))
    if predictor > 1:
        entry(_T_PREDICTOR, 3, 1, short(predictor))
    entry(_T_SAMPLE_FORMAT, 3, 1, short(fmt))
    x0, dx, rxy, y0, ryx, dy = transform
    if transform_matrix:
        # row-major 4x4: x = m0*i + m1*j + m3; y = m4*i + m5*j + m7
        entry(_T_MODEL_TRANSFORM, 12, 16, long_(extra_base + ext(
            struct.pack("<16d",
                        dx, rxy, 0.0, x0,
                        ryx, dy, 0.0, y0,
                        0.0, 0.0, 0.0, 0.0,
                        0.0, 0.0, 0.0, 1.0))))
    else:
        entry(_T_MODEL_PIXEL_SCALE, 12, 3, long_(extra_base + ext(
            struct.pack("<3d", abs(dx), abs(dy), 0.0))))
        entry(_T_MODEL_TIEPOINT, 12, 6, long_(extra_base + ext(
            struct.pack("<6d", 0, 0, 0, x0, y0, 0))))
    if nodata is not None:
        nd = (repr(float(nodata)).encode() + b"\0")
        entry(_T_GDAL_NODATA, 2, len(nd), long_(extra_base + ext(nd))
              if len(nd) > val_len else nd.ljust(val_len, b"\0"))

    entries.sort(key=lambda e: e[0])
    with open(path, "wb") as f:
        if bigtiff:
            # BigTIFF header: II, magic 43, offset-size 8, pad, 8-byte IFD
            f.write(b"II" + struct.pack("<HHH", 43, 8, 0)
                    + struct.pack("<Q", ifd_offset))
        else:
            f.write(b"II" + struct.pack("<H", 42)
                    + struct.pack("<I", ifd_offset))
        f.write(payload)
        if bigtiff:
            f.write(struct.pack("<Q", len(entries)))
            for tag, typ, cnt, val in entries:
                f.write(struct.pack("<HHQ", tag, typ, cnt)
                        + val[:8].ljust(8, b"\0"))
            f.write(struct.pack("<Q", 0))
        else:
            f.write(struct.pack("<H", len(entries)))
            for tag, typ, cnt, val in entries:
                f.write(struct.pack("<HHI", tag, typ, cnt)
                        + val[:4].ljust(4, b"\0"))
            f.write(struct.pack("<I", 0))
        for e in extra:
            f.write(e)
    return path
