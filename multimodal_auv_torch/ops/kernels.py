"""Build and load the port's hand-written CUDA kernels.

Each source in ``multimodal_auv_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, keyed by a hash of the source and the flags, so a
fresh checkout or install builds its kernels itself and an edited source is
rebuilt. It goes into the directory that ``build_dir`` names: the
environment variable ``MULTIMODAL_AUV_TORCH_BUILD_DIR`` when it is set,
else ``multimodal_auv_torch/_build/`` (listed in ``.gitignore``) when the
package directory is writable, else a per-user cache,
``$XDG_CACHE_HOME/multimodal_auv_torch`` (``~/.cache`` when unset), as for
a package installed read-only under site-packages. The sources are package
data, so a wheel carries them.

Nothing here runs at import: the CPU tests import every module, and this
machine has neither ``nvcc`` nor a card.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
(``count``, under a lock: a data-sharded serving artifact launches from
several threads) where it launches its kernel, and nowhere else, so a
caller can show that a run went through the kernels (chip_smoke.py resets
and reads it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR_ENV = "MULTIMODAL_AUV_TORCH_BUILD_DIR"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"split_sampler": 0, "stacked_sampler": 0,
                            "eps": 0, "reparam_sampler": 0, "rng_bits": 0,
                            "rng_bmlite": 0, "eps_fast": 0,
                            "noise_parts": 0, "bn_stats": 0, "bn_apply": 0}

# the BatchNorm kernels (csrc/batchnorm.cu): every forward on the card that
# records no gradient launches them, a pair per BatchNorm layer
BN_KERNELS = ("bn_stats", "bn_apply")

_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas register / spill report)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    else ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def _writable(d: Path) -> bool:
    """Whether a directory can be made or written at ``d``: its nearest
    existing ancestor takes new entries."""
    while not d.exists():
        d = d.parent
    return d.is_dir() and os.access(d, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """Where the kernel libraries are built: ``$MULTIMODAL_AUV_TORCH_BUILD_DIR``,
    else the package's ``_build/`` if writable, else the per-user cache."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    local = _PKG / "_build"
    if _writable(local):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "multimodal_auv_torch"


def build(name: str, csrc: Path = CSRC) -> BuildResult:
    """Compile ``<csrc>/<name>.cu`` (the package's ``csrc/`` by default)
    unless a library of the same source and flags is already in the build
    directory."""
    src = Path(csrc) / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"lib{name}_{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return BuildResult(out, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
