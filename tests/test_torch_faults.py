"""Failures the port handles as the JAX package does: a file that fails to
decode in any way is a logged zeros image in a packed cache (never the end
of the pack), and a posterior checkpoint that cannot be written for any
reason is logged and returns None (never the end of a training loop).

And the installed form: a wheel carries the port's kernel sources and its
import inventory, and the kernels build where the installation lets them
(``ops/kernels.py::build_dir``)."""
import logging
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import multimodal_auv_torch.data.transforms as ttransforms
import multimodal_auv_tpu.data.transforms as jtransforms
from multimodal_auv_torch.data import datasets as tdatasets
from multimodal_auv_torch.data import packing as tpacking
from multimodal_auv_tpu.data import datasets as jdatasets
from multimodal_auv_tpu.data import packing as jpacking
from tests.fixtures.make_tree import make_inference_tree, make_training_tree


def _raise_runtime_error(path, *a, **k):
    raise RuntimeError(f"decoder failed on {path}")


@pytest.mark.parametrize("kind", ["inference", "training"])
def test_pack_survives_any_decode_error_as_jax(tmp_path, monkeypatch, kind):
    """Both packages' decoder raises RuntimeError (not an OSError or a
    ValueError) on every file: both packs finish, and their arrays and
    names are equal (every image the zeros dummy)."""
    monkeypatch.setattr(ttransforms, "load_image_u8", _raise_runtime_error)
    monkeypatch.setattr(jtransforms, "load_image_u8", _raise_runtime_error)
    if kind == "inference":
        root = make_inference_tree(str(tmp_path / "dives"), n_samples=3)
        tds = tdatasets.InferenceFolderDataset(root, image_size=32)
        jds = jdatasets.InferenceFolderDataset(root, image_size=32)
        tpacking.pack_inference_dataset(tds, str(tmp_path / "t"), size=32)
        jpacking.pack_inference_dataset(jds, str(tmp_path / "j"), size=32)
        got = tpacking.load_packed(str(tmp_path / "t"))
        want = jpacking.load_packed(str(tmp_path / "j"))
    else:
        root = make_training_tree(str(tmp_path / "tree"), n_samples=4)
        tds = tdatasets.MultimodalFolderDataset(root, image_size=32)
        jds = jdatasets.MultimodalFolderDataset(root, image_size=32)
        got = tpacking.pack_training_dataset(tds, str(tmp_path / "t"),
                                             "30m", "30m", size=32)
        want = jpacking.pack_training_dataset(jds, str(tmp_path / "j"),
                                              "30m", "30m", size=32)
    for key in ("main", "bathy", "sss"):
        assert not np.asarray(got[key]).any()
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    other = "names" if kind == "inference" else "labels"
    np.testing.assert_array_equal(np.asarray(got[other]),
                                  np.asarray(want[other]))


def test_save_model_logs_any_failure_as_jax(tmp_path, caplog):
    """A ``csv_path`` holding a NUL byte in the directory the checkpoint
    goes under (``dirname(dirname(csv_path))``) makes the write raise
    ValueError in both packages: each logs the failure and returns
    None."""
    import jax
    import torch

    from multimodal_auv_torch.bayes.packing import PackedPosterior
    from multimodal_auv_torch.engine.checkpointing import save_model
    from multimodal_auv_tpu.engine.checkpointing import (
        save_model as jax_save_model,
    )

    bad = str(tmp_path / "run\0x" / "csvs" / "ledger.csv")
    post = PackedPosterior(torch.zeros(8), torch.zeros(8), {})
    with caplog.at_level(logging.ERROR):
        assert save_model(post, bad, "multimodal") is None
        assert jax_save_model({"mu": jax.numpy.zeros(8)}, bad,
                              "multimodal") is None
    failures = [r for r in caplog.records
                if "Failed to save model checkpoint" in r.getMessage()]
    assert len(failures) == 2


REPO = Path(__file__).resolve().parent.parent


def test_wheel_carries_kernel_sources_and_inventory(tmp_path):
    """A wheel built offline from the project file and the port's package
    holds the CUDA source that ``ops/kernels.py`` compiles at first use,
    the host C++ source that ``native/`` compiles at first use and the
    inventory that ``interop/hf_manifest.py`` reads. Built in a copy:
    a build in the repository would write ``build/`` and ``*.egg-info``
    there."""
    shutil.copy(REPO / "pyproject.toml", tmp_path)
    shutil.copytree(REPO / "multimodal_auv_torch",
                    tmp_path / "multimodal_auv_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    env = dict(os.environ, PIP_NO_INDEX="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w", "dist",
                    "."], cwd=tmp_path, env=env, check=True, timeout=300)
    (whl,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(whl).namelist())
    assert "multimodal_auv_torch/csrc/sampling.cu" in names
    assert "multimodal_auv_torch/native/csrc/auvnative.cpp" in names
    assert "multimodal_auv_torch/interop/expected_hf_keys.json" in names


def _fake_package(tmp_path, monkeypatch, read_only):
    """Point ``ops/kernels.py`` at a package directory under ``tmp_path``;
    ``read_only``: mode 0o555 and no write access by ``os.access`` (which
    root would otherwise be granted whatever the mode)."""
    from multimodal_auv_torch.ops import kernels

    pkg = tmp_path / "site-packages" / "multimodal_auv_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(kernels, "_PKG", pkg)
    monkeypatch.delenv(kernels.BUILD_DIR_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if read_only:
        pkg.chmod(0o555)
        real_access = os.access

        def access(path, mode, **kw):
            if Path(path).resolve().is_relative_to(pkg) and mode & os.W_OK:
                return False
            return real_access(path, mode, **kw)

        monkeypatch.setattr(kernels.os, "access", access)
    return kernels, pkg


def test_kernel_build_dir_is_the_package_build_when_writable(tmp_path,
                                                              monkeypatch):
    kernels, pkg = _fake_package(tmp_path, monkeypatch, read_only=False)
    assert kernels.build_dir() == pkg / "_build"


def test_kernel_build_dir_falls_back_to_user_cache(tmp_path, monkeypatch):
    """Under a read-only package directory the build goes to
    ``$XDG_CACHE_HOME/multimodal_auv_torch``, or ``~/.cache`` without
    it."""
    kernels, pkg = _fake_package(tmp_path, monkeypatch, read_only=True)
    try:
        assert kernels.build_dir() == tmp_path / "cache" / "multimodal_auv_torch"
        monkeypatch.delenv("XDG_CACHE_HOME")
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        assert kernels.build_dir() == (tmp_path / "home" / ".cache"
                                       / "multimodal_auv_torch")
    finally:
        pkg.chmod(0o755)


@pytest.mark.parametrize("read_only", [False, True])
def test_kernel_build_dir_env_wins(tmp_path, monkeypatch, read_only):
    kernels, pkg = _fake_package(tmp_path, monkeypatch, read_only)
    try:
        monkeypatch.setenv(kernels.BUILD_DIR_ENV, str(tmp_path / "kb"))
        assert kernels.build_dir() == tmp_path / "kb"
    finally:
        pkg.chmod(0o755)


def test_torch_extra_covers_the_ports_module_imports():
    """``pyproject.toml``'s ``torch`` extra lists every third-party
    distribution the port imports at module level (its package's
    import-time needs: a ``pip install --no-deps .`` plus these runs it);
    the optional ones (zstandard, cv2, matplotlib, huggingface_hub,
    tensorboard) are imported inside the functions that need them."""
    import ast
    import tomllib

    repo = Path(__file__).resolve().parent.parent
    with open(repo / "pyproject.toml", "rb") as f:
        extra = tomllib.load(f)["project"]["optional-dependencies"]["torch"]
    dist = {"torch": "torch", "numpy": "numpy", "PIL": "pillow",
            "yaml": "pyyaml"}
    stdlib = set(sys.stdlib_module_names)
    seen = set()
    for path in (repo / "multimodal_auv_torch").rglob("*.py"):
        for node in ast.parse(path.read_text()).body:  # module level only
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module and not node.level else [])
            for name in names:
                top = name.split(".")[0]
                if top not in stdlib and top != "multimodal_auv_torch":
                    seen.add(top)
    assert seen <= set(dist), seen - set(dist)
    assert {dist[m] for m in seen} <= set(extra)
    assert "jax" not in extra and set(extra) <= set(dist.values())


def test_no_deps_install_runs_the_torch_scripts(tmp_path):
    """``pip install --no-deps --no-build-isolation .`` (offline: no
    dependency resolved, no build backend fetched), as on a card machine
    without the JAX stack, installs the port and its console scripts,
    which then run: ``multimodal-auv-torch-data-check --help`` from the
    install alone. Installed from a copy of the project file and the
    port's package into a target directory."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(REPO / "pyproject.toml", src)
    shutil.copytree(REPO / "multimodal_auv_torch",
                    src / "multimodal_auv_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    site = tmp_path / "site"
    env = dict(os.environ, PIP_NO_INDEX="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "--target",
                    str(site), "."], cwd=src, env=env, check=True,
                   timeout=300)
    script = site / "bin" / "multimodal-auv-torch-data-check"
    assert script.exists()
    env = dict(os.environ, PYTHONPATH=str(site))
    out = subprocess.run([sys.executable, str(script), "--help"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--root_dir" in out.stdout
    assert (site / "multimodal_auv_torch" / "csrc" / "sampling.cu").exists()
