"""ctypes bindings for the port's C++ host runtime (``csrc/auvnative.cpp``,
its own copy of the JAX package's ``native/``): LZW decode, threaded
bilinear uint8 resize, uint8 -> f32 normalise, uint8 -> f64 accumulate,
clipped window copy, and JPEG / PNG decode + convert + resize.

``lib`` is built at first use, not at import: the first access to
``multimodal_auv_torch.native.lib`` compiles the source with ``g++``
into ``ops/kernels.py::build_dir()`` and loads it. The flags are the JAX
package's Makefile's (``-O3``, and ``-march=native`` where the compiler
takes it, so both libraries round alike: the normalise contracts to FMAs
where the CPU has them), and the build is keyed by a hash of the source,
the flags and the host CPU's features, so a build directory shared by
hosts never hands one another's instructions. It links libjpeg and libpng
when they link; without them the library is built without
``decode_image_u8`` and ``lib.has_decode`` is False. Every consumer treats
``lib`` as optional (None where no compiler is found: the numpy / PIL
fallbacks run), as the JAX package's loader does.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "csrc" / "auvnative.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
DECODE_FLAGS = ("-DAUVNATIVE_DECODE",)
DECODE_LIBS = ("-ljpeg", "-lpng")
_lock = threading.Lock()


class NativeLib:
    def __init__(self, cdll: ctypes.CDLL):
        self._c = cdll
        c = cdll
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i = ctypes.c_int
        i64 = ctypes.c_int64

        c.resize_bilinear_u8_batch.argtypes = [u8p, i, i, i, i, u8p, i, i, i]
        c.normalize_u8_to_f32.argtypes = [u8p, i64, i, f32p, f32p, f32p]
        c.accumulate_u8_f64.argtypes = [u8p, i64, f64p]
        c.window_copy.argtypes = [u8p, i, i, i, u8p, i, i, i, i]
        c.lzw_decode.argtypes = [u8p, i64, u8p, i64]
        c.lzw_decode.restype = i64
        # decode_image_u8 exists only in builds linked against
        # libjpeg/libpng
        try:
            c.decode_image_u8.argtypes = [u8p, i64, u8p, i, i, i]
            c.decode_image_u8.restype = i
            self.has_decode = True
        except AttributeError:
            self.has_decode = False

    # -- numpy-facing wrappers ---------------------------------------------

    def resize_batch(self, images: np.ndarray, dh: int, dw: int,
                     nthreads: int = 0) -> np.ndarray:
        """images: (N, H, W, C) uint8 -> (N, dh, dw, C) uint8."""
        images = np.ascontiguousarray(images, np.uint8)
        n, sh, sw, ch = images.shape
        out = np.empty((n, dh, dw, ch), np.uint8)
        if nthreads <= 0:
            nthreads = min(max((os.cpu_count() or 2) - 2, 1), n)
        self._c.resize_bilinear_u8_batch(
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, sh, sw,
            ch, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw,
            nthreads)
        return out

    def normalize(self, img: np.ndarray, mean, std) -> np.ndarray:
        """(..., C) uint8 -> float32, x/255 then (x-mean)/std per channel."""
        img = np.ascontiguousarray(img, np.uint8)
        c = img.shape[-1]
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        out = np.empty(img.shape, np.float32)
        self._c.normalize_u8_to_f32(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            img.size // c, c,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def accumulate(self, img: np.ndarray, acc: np.ndarray) -> None:
        img = np.ascontiguousarray(img, np.uint8)
        assert acc.dtype == np.float64 and acc.size == img.size
        self._c.accumulate_u8_f64(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.size,
            acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def window_copy(self, src: np.ndarray, dst: np.ndarray,
                    row_off: int, col_off: int) -> None:
        """Clipped copy of src[(row_off:…, col_off:…)] into dst (2-D)."""
        src = np.ascontiguousarray(src)
        assert dst.flags["C_CONTIGUOUS"] and src.dtype == dst.dtype
        self._c.window_copy(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            src.shape[0], src.shape[1], src.dtype.itemsize,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dst.shape[0], dst.shape[1], row_off, col_off)

    def decode_image(self, data: bytes, mode: str, dh: int,
                     dw: int) -> Optional[np.ndarray]:
        """Decode a JPEG/PNG byte buffer straight to (dh, dw, C) uint8,
        converting to ``mode`` ("RGB" or "L") and resizing: PIL's pixels
        (the same libjpeg decode, PIL's L24 luma, convert-then-resize
        order; csrc comments), resized by ``resize_batch``. Returns None
        for anything the C path does not handle (the caller falls back to
        PIL)."""
        if not self.has_decode or mode not in ("RGB", "L"):
            return None
        ch = 1 if mode == "L" else 3
        src = np.frombuffer(data, np.uint8)
        out = np.empty((dh, dw, ch), np.uint8)
        rc = self._c.decode_image_u8(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw, ch)
        return out if rc == 0 else None

    def lzw_decode(self, data: bytes, expected: int) -> bytes:
        src = np.frombuffer(data, np.uint8)
        dst = np.zeros(expected, np.uint8)
        n = self._c.lzw_decode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected)
        if n < 0:
            raise ValueError("corrupt LZW stream")
        # the decoded length: a truncated strip that decodes to fewer than
        # ``expected`` bytes is a short read (as the pure-Python fallback
        # returns it), not zero-padded raster rows
        return dst.tobytes()[:n]


def _host_features() -> str:
    """The host CPU's feature flags (Linux), else its machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return platform.machine()


def _march(cxx: str) -> tuple:
    """``-march=native`` where the compiler takes it (the Makefile's
    probe)."""
    probe = subprocess.run([cxx, "-march=native", "-E", "-x", "c++",
                            os.devnull], capture_output=True, timeout=60)
    return ("-march=native",) if probe.returncode == 0 else ()


def _compile(flags, libs) -> Path:
    """The library of the source under ``flags`` + ``libs`` in the build
    directory, compiled there unless already built (RuntimeError with
    g++'s output when it fails)."""
    from multimodal_auv_torch.ops.kernels import build_dir

    cxx = shutil.which("g++") or "g++"
    args = (*CXX_FLAGS, *_march(cxx), *flags)
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(args + libs).encode()
                          + _host_features().encode()).hexdigest()[:16]
    out = build_dir() / f"libauvnative_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *args, "-o", str(tmp), str(SOURCE),
                           "-lpthread", *libs], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE} (rc "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: a process loading it sees a whole file
    return out


def _load() -> Optional[NativeLib]:
    """Build (with decode when libjpeg and libpng link, else without) and
    load the library; None, with a warning, where neither build works."""
    for flags, libs in ((DECODE_FLAGS, DECODE_LIBS), ((), ())):
        try:
            return NativeLib(ctypes.CDLL(str(_compile(flags, libs))))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native host library%s unavailable: %s",
                           " with JPEG/PNG decode" if libs else "", e)
    return None


def __getattr__(name):
    # ``lib``: built and loaded on first access, then a plain attribute
    if name == "lib":
        with _lock:
            if "lib" not in globals():
                globals()["lib"] = _load()
        return globals()["lib"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
