"""The UIFM degradation (engine/uifm.py) and the noise study
(pipelines/noise_study.py) of the port against the JAX package's, on the
CPU: the degradation on the same image, distance, turbidity and depth
(f32, 1e-6 relative to the terms it adds) with the limits of tests/test_noise_and_metrics.py;
``_build_inputs`` at one turbidity; ``evaluate_with_degradation`` with a
stub eval step of fixed metrics giving equal CSVs; and a micro()
``run_noise_study`` end to end with JAX's files and columns. The sampler
noise cannot match across frameworks (ROADMAP "Rules for the port"), so
the end-to-end run is held to the schema and finite values."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.data.loaders import (
    prepare_datasets_and_loaders as t_loaders,
)
from multimodal_auv_torch.engine import uifm as TU
from multimodal_auv_torch.engine.optim import BayesTrainState as TState
from multimodal_auv_torch.models.model_utils import ArchConfig as TArch
from multimodal_auv_torch.pipelines import noise_study as TN
from multimodal_auv_tpu.data.loaders import (
    prepare_datasets_and_loaders as j_loaders,
)
from multimodal_auv_tpu.engine import uifm as JU
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.pipelines import noise_study as JN
from tests.fixtures.make_tree import make_training_tree

# f32, relative to the magnitude of the two terms the formula adds
# (|J| t + B_inf (1 - t)): XLA:CPU contracts J * t + B_inf * (1 - t) into an
# FMA and its exp may differ from torch's by an ulp, so where the terms
# cancel (J < 0, the noise study's normalised images) the sum's own
# relative error is unbounded while its error against the terms is ~1 ulp
RTOL = 1e-6


def assert_close_to_terms(got, want, img, dmap, turb, depth):
    beta = np.asarray(TU.BETA_RGB) * turb
    t = np.exp(-beta * np.asarray(dmap, np.float64) * depth)
    scale = np.abs(np.asarray(img, np.float64)) * t + np.asarray(
        TU.B_INF_RGB) * (1 - t)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= RTOL * scale + 1e-30).all(), float((err / scale).max())


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_training_tree(str(tmp_path_factory.mktemp("ns") / "data"),
                              n_samples=6)


@pytest.mark.parametrize("turb,depth,full_map", [
    (0.37, 1.0, False), (1.5, 0.4, True), (2.05, 1.0, True), (0.05, 0.7,
                                                            False)])
def test_degradation_matches_jax(turb, depth, full_map):
    """Normalised-range images (the noise study's input, values well
    outside [0, 1]) through both formulas."""
    rng = np.random.default_rng(0)
    img = (rng.normal(size=(2, 8, 8, 3)) * 1.5).astype(np.float32)
    dmap = (rng.random((2, 8, 8, 1)) * 2 if full_map
            else np.ones((1, 1, 1, 1))).astype(np.float32)
    want = np.asarray(JU.simulate_underwater_degradation(
        jnp.asarray(img), jnp.asarray(dmap), jnp.float32(turb),
        jnp.float32(depth)))
    got = TU.simulate_underwater_degradation(
        torch.from_numpy(img), torch.from_numpy(dmap), turb, depth).numpy()
    assert got.dtype == np.float32
    assert_close_to_terms(got, want, img, dmap, turb, depth)
    if not full_map:
        got_u = TU.degrade_uniform(torch.from_numpy(img), turb, depth).numpy()
        want_u = np.asarray(JU.degrade_uniform(jnp.asarray(img), turb, depth))
        assert_close_to_terms(got_u, want_u, img, dmap, turb, depth)


def test_degradation_limits():
    """tests/test_noise_and_metrics.py's limits on the port: the golden
    formula, zero turbidity the identity, extreme turbidity B_inf, the
    output in [0, 1]."""
    img = torch.full((1, 2, 2, 3), 0.6)
    out = TU.simulate_underwater_degradation(img, torch.ones(1, 2, 2, 1),
                                             1.5, 1.0).numpy()
    for c in range(3):
        t = np.exp(-TU.BETA_RGB[c] * 1.5)
        np.testing.assert_allclose(out[0, :, :, c],
                                   0.6 * t + TU.B_INF_RGB[c] * (1 - t),
                                   rtol=1e-5)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 4, 4, 3)).astype(np.float32))
    np.testing.assert_allclose(TU.degrade_uniform(x, 0.0).numpy(), x.numpy(),
                               atol=1e-6)
    heavy = TU.degrade_uniform(x, 1000.0).numpy()
    for c in range(3):
        np.testing.assert_allclose(heavy[..., c], TU.B_INF_RGB[c], atol=1e-5)
    assert heavy.min() >= 0.0 and heavy.max() <= 1.0
    assert (TU.BETA_RGB, TU.B_INF_RGB) == (JU.BETA_RGB, JU.B_INF_RGB)


def test_sample_turbidity_range():
    g = torch.Generator().manual_seed(3)
    draws = [TU.sample_turbidity(g, (0.3, 0.4)) for _ in range(200)]
    assert all(0.3 <= t < 0.4 for t in draws) and len(set(draws)) == 200
    assert TU.sample_turbidity(g, (0.5, 0.5)) == 0.5


@pytest.mark.parametrize("modality", ["multimodal", "image"])
def test_build_inputs_matches_jax(tree, modality):
    """A ragged batch (2 of nominal 4 rows) at one turbidity (lo == hi):
    the degraded optical input, the patches, labels, mask and row count."""
    turb, depth = 1.25, 0.8
    jl = j_loaders(tree, batch_size_multimodal=4, image_size=32)[3]
    tl = t_loaders(tree, batch_size_multimodal=4, image_size=32)[3]
    jb, tb = next(iter(jl)), next(iter(tl))
    assert len(tb["label"]) == 2
    want = JN._build_inputs(jb, jax.random.PRNGKey(0), (turb, turb), depth,
                            modality, "patch_10m_bathy", None, 4)
    got = TN._build_inputs(tb, torch.Generator().manual_seed(0),
                           (turb, turb), depth, modality, "patch_10m_bathy",
                           None, 4, torch.device("cpu"))
    assert len(got[0]) == len(want[0]) == (3 if modality == "multimodal"
                                           else 1)
    img = np.asarray(tb["main_image"])
    img = np.concatenate([img, np.repeat(img[-1:], 2, 0)])
    assert_close_to_terms(got[0][0].numpy(), np.asarray(want[0][0]), img,
                          np.ones((1, 1, 1, 1)), turb, depth)
    for g, w in zip(got[0][1:], want[0][1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert got[3] == want[3] == 4


def _fixed_metrics(n_calls, nominal, classes=3, seed=7):
    """Per-call eval metrics, f32 as both packages' steps return them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_calls):
        p = rng.random((nominal, classes)).astype(np.float32)
        out.append({
            "loss": np.float32(rng.random() * 3),
            "correct": np.float32(rng.integers(0, nominal + 1)),
            "total": np.float32(nominal),
            "predicted": rng.integers(0, classes, nominal).astype(np.int32),
            "predictive_entropy": rng.random(nominal).astype(np.float32),
            "model_uncertainty": rng.random(nominal).astype(np.float32),
            "aleatoric_entropy": rng.random(nominal).astype(np.float32),
            "mean_prob": p / p.sum(1, keepdims=True),
        })
    return out


def _torch_fused(m):
    """The port's eval-step metrics layout (engine/steps.py)."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32).reshape(-1))
    z = np.zeros_like(m["predictive_entropy"])
    fused = torch.cat([f([m["loss"], 0.0, 0.0, m["correct"], m["total"]]),
                       f(m["predicted"]), f(m["predictive_entropy"]),
                       f(m["aleatoric_entropy"]), f(m["model_uncertainty"]),
                       f(z), f(z), f(m["mean_prob"])])
    return {"fused": fused, "predicted": torch.from_numpy(m["predicted"])}


def test_evaluate_with_degradation_csvs_equal(tree, tmp_path):
    """A stub eval step returning the same fixed metrics in both
    packages: the eval CSV (with the appended AUROC / F1 / ECE / Emax /
    Turbidity / Depth) and the per-sample CSV are equal byte for byte."""
    jl = j_loaders(tree, batch_size_multimodal=1, image_size=32)[3]
    tl = t_loaders(tree, batch_size_multimodal=1, image_size=32)[3]
    fixed = _fixed_metrics(len(tl), 1)
    calls = {"jax": iter(fixed), "torch": iter(fixed)}
    jstep = lambda *a: next(calls["jax"])
    tstep = lambda *a: _torch_fused(next(calls["torch"]))
    jstate = JN.BayesTrainState(post=None, opt_state=None, batch_stats=None,
                                step=None)
    tstate = TState(post=type("P", (), {"mu": torch.zeros(1)})(),
                    opt_state=None, batch_stats=None)
    paths = {}
    for name in ("jax", "torch"):
        csv_path = str(tmp_path / name / "noise_study_depth1.0.csv")
        for epoch in range(2):  # two rows: the append goes to the last
            if name == "jax":
                calls["jax"] = iter(fixed)
                res = JN.evaluate_with_degradation(
                    jstep, jstate, jl, epoch, 2, csv_path, "multimodal",
                    jax.random.PRNGKey(1), (0.3, 0.4), 1.0)
            else:
                calls["torch"] = iter(fixed)
                res = TN.evaluate_with_degradation(
                    tstep, tstate, tl, epoch, 2, csv_path, "multimodal",
                    torch.Generator().manual_seed(1), (0.3, 0.4), 1.0)
            paths.setdefault(name, []).append(res)
        per = sorted(os.listdir(tmp_path / name / "per_sample_metrics"))
        paths[name] = [csv_path] + [str(tmp_path / name / "per_sample_metrics"
                                        / p) for p in per]
    assert len(paths["torch"]) == len(paths["jax"]) == 3
    for a, b in zip(paths["jax"], paths["torch"]):
        assert open(a, "rb").read() == open(b, "rb").read(), (a, b)
    rows = list(csv.DictReader(open(paths["torch"][0])))
    assert rows[-1]["Turbidity"] == "0.350" and rows[-1]["Depth"] == "1.0"
    # seed 7: one error and one right prediction, so the AUROC is defined
    assert rows[-1]["uncertainty_error_auroc"] not in ("", "nan")


def _run(pkg, root, csv_dir, modality):
    kw = dict(turbidity_centers=[0.05, 2.05], depth_levels=[1.0],
              train_epochs_per_step=1, num_mc=2, batch_size=3,
              modality=modality)
    if pkg == "jax":
        return JN.run_noise_study(root, csv_dir, arch=JArch.micro(
            image_size=64), **kw)
    return TN.run_noise_study(root, csv_dir, arch=TArch.micro(image_size=64),
                              device="cpu", **kw)


@pytest.mark.parametrize("modality", ["multimodal", "image"])
def test_run_noise_study_micro_matches_jax_schema(tree, tmp_path, modality):
    """Two turbidity centres, one fine-tuning epoch each, micro() at
    64 px, through both packages on the CPU (the three-trunk model, and
    the single optical trunk of ``modality="image"``): the same files,
    the same columns, one row per centre, finite values."""
    out = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        res = _run(pkg, tree, d, modality)
        files = sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs)
        out[pkg] = (res, files, d)
    (jres, jfiles, jd), (tres, tfiles, td) = out["jax"], out["torch"]
    assert tfiles == jfiles
    assert [sorted(r) for r in tres] == [sorted(r) for r in jres]
    assert [(r["turbidity"], r["depth"]) for r in tres] == [(0.05, 1.0),
                                                           (2.05, 1.0)]
    text = {"Model Type", "bathy Patch Type", "SSS Patch Type"}
    for rel in tfiles:
        jrows = list(csv.reader(open(os.path.join(jd, rel))))
        trows = list(csv.DictReader(open(os.path.join(td, rel))))
        assert list(trows[0]) == jrows[0] and len(trows) == len(jrows) - 1
        for row in trows:
            for k, v in row.items():
                if k in text:
                    continue
                # sklearn's rule: one class only -> "nan" (every row errs)
                ok = v == "nan" if k == "uncertainty_error_auroc" else False
                assert ok or np.isfinite(float(v)), (rel, k, v)
    rows = list(csv.DictReader(open(os.path.join(td,
                                                 "noise_study_depth1.0.csv"))))
    assert [r["Turbidity"] for r in rows] == ["0.050", "2.050"]
    assert rows[-1]["Depth"] == "1.0"
    for r in tres:
        assert np.isfinite([r["loss"], r["accuracy"], r["f1"], r["ece"]]).all()


def test_run_noise_study_needs_the_card_by_default(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.run_noise_study(tree, str(tmp_path), arch=TArch.micro())
    with pytest.raises(ValueError, match="modality"):
        TN.run_noise_study(tree, str(tmp_path), arch=TArch.micro(),
                           modality="sss", device="cpu")
