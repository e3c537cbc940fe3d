"""The port's examples (``examples/torch/``): each of the ten scripts run
as ``__main__`` in this process (``runpy``) with ``--device cpu`` and
``--tiny`` (``ArchConfig.micro()``) on the fixture trees, at their
smallest flags, producing its artefact (CSV, checkpoint, .pth, artifact
directory, HTTP reply); a static check that no file there imports JAX or
the JAX package; and each keeps the flags of its JAX twin in
``examples/``."""
import ast
import contextlib
import io
import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures.make_tree import make_inference_tree, make_training_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples", "torch")
EXAMPLES = ("example_inference", "example_retraining",
            "example_training_from_scratch", "example_data_preparation",
            "example_noise_study", "example_unimodal_noise",
            "example_export", "example_export_serving", "example_serve",
            "research_driver")
CPU = ["--device", "cpu", "--tiny"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread (as tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    """No Hub access; logs/ and tensorboard_logs/ under a scratch cwd."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.chdir(tmp_path)


def run_example(name: str, *argv: str) -> str:
    """Run ``examples/torch/<name>.py`` as ``__main__`` with ``argv``;
    returns what it printed. ``examples/torch`` goes first on sys.path,
    as Python puts a script's directory there (its ``_bootstrap``, not
    the JAX examples' one)."""
    path = os.path.join(EX, f"{name}.py")
    saved = sys.argv, list(sys.path), sys.modules.pop("_bootstrap", None)
    sys.argv = [path, *argv]
    sys.path.insert(0, EX)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved[0], saved[1]
        sys.modules.pop("_bootstrap", None)
        if saved[2] is not None:
            sys.modules["_bootstrap"] = saved[2]
    return out.getvalue()


def _rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split(",") for ln in f if ln.strip()]


def _model_files(root):
    d = os.path.join(root, "models")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``example_training_from_scratch`` once, 1 epoch: its tree (with
    the ledgers under csvs/ and the epoch-0 ``save_model`` file under
    models/)."""
    root = make_training_tree(str(tmp_path_factory.mktemp("scratch")
                                  / "tree"), n_samples=6)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(root))
    try:
        run_example("example_training_from_scratch", "--root_dir", root,
                    "--epochs", "1", "--num_mc", "2", "--batch_size", "2",
                    *CPU)
    finally:
        os.chdir(cwd)
    return root


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """``example_export_serving`` once: (its artifact directory, what it
    printed)."""
    d = str(tmp_path_factory.mktemp("serving") / "art")
    printed = run_example("example_export_serving", "--output_dir", d,
                          "--batch_size", "4", "--num_mc_samples", "2",
                          "--allow_random_init", *CPU)
    return d, printed


def test_example_inference(tmp_path):
    """A CSV of one row per dive folder, random weights."""
    dives = make_inference_tree(str(tmp_path / "dives"), n_samples=5)
    out = str(tmp_path / "o.csv")
    run_example("example_inference", "--data_dir", dives, "--output_csv",
                out, "--batch_size", "2", "--num_mc_samples", "2",
                "--allow_random_init", *CPU)
    rows = _rows(out)
    assert rows[0][:2] == ["Image Name", "Predicted Class"]
    assert len(rows) == 6


def test_example_training_from_scratch(trained):
    """One epoch: the train and eval ledgers of one row each and the
    epoch-0 checkpoint."""
    for name in ("multimodal_train_results.csv",
                 "multimodal_eval_results.csv"):
        assert len(_rows(os.path.join(trained, "csvs", name))) == 2, name
    assert len(_model_files(trained)) == 1


def test_example_retraining(tmp_path):
    """Retraining from a random init onto the tree's 3 classes, 1 epoch:
    the ledgers and the epoch-0 checkpoint of a 3-class posterior."""
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    run_example("example_retraining", "--data_dir", root, "--num_classes",
                "3", "--epochs", "1", "--num_mc", "2", "--batch_size", "2",
                "--allow_random_init", *CPU)
    assert len(_rows(os.path.join(root, "csvs",
                                  "multimodal_train_results.csv"))) == 2
    (name,) = _model_files(root)
    from multimodal_auv_torch.engine.checkpointing import load_posterior

    post = load_posterior(os.path.join(root, "models", name))
    assert post.mu.shape == post.rho.shape and post.mu.shape[0] > 1000


def test_example_export(trained, tmp_path):
    """The training example's ``save_model`` file exported as a
    bayesian-torch .pth: imported back into a fresh bundle it gives the
    checkpoint's posterior on every entry but the 3-class head, which
    the importer drops (it re-initialises any head whose class count
    differs from the published model's 7, as the reference does)."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.checkpointing import load_posterior
    from multimodal_auv_torch.interop.torch_import import (
        load_and_prepare_multimodal_model,
    )
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )

    (name,) = _model_files(trained)
    ckpt = os.path.join(trained, "models", name)
    out = str(tmp_path / "export.pth")
    printed = run_example("example_export", "--checkpoint", ckpt,
                          "--num_classes", "3", "--out", out, *CPU)
    assert f"exported -> {out}" in printed
    bundle = make_multimodal_bundle(3, BNNPriorSpec(),
                                    torch.Generator().manual_seed(1),
                                    ArchConfig.micro(), device="cpu")
    bundle, stats = load_and_prepare_multimodal_model(bundle, out, 3)
    want = load_posterior(ckpt)
    kept = [e for e in bundle.meta.entries if e.path[0] != "fc2"]
    assert len(kept) > 50
    for e in kept:
        sl = slice(e.offset, e.offset + e.size)
        assert torch.equal(bundle.post.mu[sl], want.mu[sl]), e.path
        assert torch.equal(bundle.post.rho[sl], want.rho[sl]), e.path


def _raw_survey(root):
    """Three GAVIA JPEGs with their telemetry in the COM segment and a
    bathymetry and an SSS GeoTIFF covering them (as
    tests/test_torch_dataprep.py writes them)."""
    from multimodal_auv_torch.dataprep.geodesy import latlon_to_utm
    from multimodal_auv_torch.dataprep.geotiff import write_geotiff

    com = ("<telemetry><lat>5530.000N</lat><lon>00530.000W</lon>"
           "<altitude>2.5</altitude><depth>30.0</depth>"
           "<heading>180.0</heading><pitch>1.0</pitch><roll>0.5</roll>"
           "<surge>0.1</surge><sway>0.2</sway></telemetry>")
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "dive1"))
    for i in range(3):
        Image.fromarray(rng.integers(40, 90, (64, 64, 3), dtype=np.uint8)
                        ).save(os.path.join(raw, "dive1",
                                            f"frame_{i:04d}.jpg"),
                               comment=com.encode())
    e, n, _, _ = latlon_to_utm(55.5, -5.5)
    tr = (e - 50.0, 0.5, 0.0, n + 50.0, 0.0, -0.5)
    tiffs = os.path.join(root, "tiffs")
    os.makedirs(tiffs)
    write_geotiff(os.path.join(tiffs, "site_a_b_Bathy.tif"),
                  rng.integers(0, 256, (200, 200, 2)).astype(np.uint8), tr)
    write_geotiff(os.path.join(tiffs, "site_a_b_SSS.tif"),
                  rng.integers(0, 256, (200, 200)).astype(np.uint8), tr)
    return raw, tiffs


def test_example_data_preparation(tmp_path):
    """Raw frames and GeoTIFFs -> one sample folder per frame."""
    raw, tiffs = _raw_survey(str(tmp_path))
    out = str(tmp_path / "out")
    run_example("example_data_preparation", "--raw_optical_images_folder",
                raw, "--geotiff_folder", tiffs, "--output_folder", out)
    samples = os.path.join(out, "samples")
    assert len(os.listdir(samples)) == 3
    assert os.path.exists(os.path.join(samples, "frame_0000",
                                       "combined_channels.png"))


@pytest.mark.parametrize("name,ledger", [
    ("example_noise_study", "noise_study_csvs"),
    ("example_unimodal_noise", "unimodal_noise_csvs")])
def test_example_noise_studies(tmp_path, name, ledger):
    """The multimodal and the unimodal optical noise study, evaluation
    only: one result printed per turbidity centre (6) and the study's
    CSVs under ``--csv_dir``."""
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    csv_dir = str(tmp_path / ledger)
    printed = run_example(name, "--root_dir", root, "--csv_dir", csv_dir,
                          "--num_mc", "2", "--batch_size", "2", *CPU)
    assert len([ln for ln in printed.splitlines()
                if ln.startswith("{")]) == 6
    assert any(f.endswith(".csv") for f in os.listdir(csv_dir))


def test_example_export_serving(artifact):
    """The artifact directory (meta.json beside its programs) and three
    batches served from it."""
    d, printed = artifact
    assert os.path.exists(os.path.join(d, "meta.json"))
    assert [ln.split(" (")[0] for ln in printed.splitlines()
            if ln.startswith("batch")] == ["batch 0", "batch 1", "batch 2"]


def test_example_serve(artifact):
    """The HTTP host on the exported artifact: healthz, one prediction
    per posted row, the metrics."""
    d, _ = artifact
    printed = run_example("example_serve", "--artifact", d,
                          "--num_mc_samples", "2", *CPU)
    assert printed.startswith("healthz:")
    assert len([ln for ln in printed.splitlines()
                if ln.startswith("sample ")]) == 4
    assert "--- /metrics ---" in printed


def test_research_driver(tmp_path):
    """Unimodal training of the three modalities (2 epochs: the first is
    skipped, as the reference's loop) and the sweep at one combo (30 m x
    30 m, the tree's patches), one epoch: the best combo printed and the
    sweep's summary written."""
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    csv_dir = str(tmp_path / "research")
    printed = run_example("research_driver", "--root_dir", root,
                          "--csv_dir", csv_dir, "--unimodal_epochs", "2",
                          "--sweep_epochs", "1", "--num_mc", "2",
                          "--grid", "30", *CPU)
    assert "Best combo:" in printed
    assert os.path.exists(os.path.join(csv_dir, "patch_sweep_summary.csv"))
    for m in ("image", "sss", "bathy"):
        assert os.path.exists(os.path.join(
            csv_dir, f"unimodal_{m}_train_results.csv")), m


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _flags(path):
    """The option strings a script's parser takes: its ``add_argument``
    calls', and ``--device`` / ``--tiny`` where it calls
    ``_bootstrap.add_common``."""
    tree = ast.parse(open(path).read())
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)]
    flags = {a.value for node in calls
             if getattr(node.func, "attr", "") == "add_argument"
             for a in node.args if isinstance(a, ast.Constant)}
    if any(getattr(node.func, "attr", "") == "add_common" for node in calls):
        flags |= {"--device", "--tiny"}
    return flags


def test_examples_import_no_jax_and_keep_the_flags():
    """No file of ``examples/torch/`` imports jax, flax, optax or
    ``multimodal_auv_tpu``; there is one port example per JAX example,
    and each takes every flag of its JAX twin."""
    files = sorted(f for f in os.listdir(EX) if f.endswith(".py"))
    assert files == sorted([f"{n}.py" for n in EXAMPLES] + ["_bootstrap.py"])
    banned = ("jax", "flax", "optax", "multimodal_auv_tpu")
    for f in files:
        for mod in _imports(os.path.join(EX, f)):
            assert mod.split(".")[0] not in banned, (f, mod)
    jax_dir = os.path.join(REPO, "examples")
    assert sorted(f[:-3] for f in os.listdir(jax_dir)
                  if f.endswith(".py") and f != "_bootstrap.py") == sorted(
        EXAMPLES)
    for n in EXAMPLES:
        want = _flags(os.path.join(jax_dir, f"{n}.py"))
        got = _flags(os.path.join(EX, f"{n}.py"))
        assert want <= got, (n, want - got)
        # every example that runs a model takes --device (data-prep runs
        # on the host only)
        assert ("--device" in got) == (n != "example_data_preparation"), n
