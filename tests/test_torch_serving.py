"""The port's serving artifact (multimodal_auv_torch/serving.py): export ->
load -> predict must be bit-exact against the in-process packed predict
step at the same seeds, the loader must not need the model code, and the
artifact must agree with the JAX package's own artifact on the same
posterior. Cases follow tests/test_serving.py where they apply.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.predict import make_packed_predict_step
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.serving import (
    ARTIFACT_VERSION,
    export_predict_artifact,
    fold_seed,
    load_predict_artifact,
)
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from multimodal_auv_tpu.serving import export_predict_artifact as jax_export
from multimodal_auv_tpu.serving import load_predict_artifact as jax_load

ARCH = ArchConfig.micro()
B, S, MC, C = 4, 32, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this module: its graphs are tiny, and with
    the suite's parallel workers the idle threads of each small op's
    parallel region spin on cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle(seed=0):
    return make_multimodal_bundle(C, BNNPriorSpec(),
                                  torch.Generator().manual_seed(seed), ARCH,
                                  device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A static-batch artifact exported through the pipeline API (random
    init, offline), its bundle rebuilt from the same seed, and one loaded
    instance."""
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact

    d = str(tmp_path_factory.mktemp("artifact"))
    old = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        out = export_auv_serving_artifact(
            d, batch_size=B, num_mc_samples=MC, num_classes=C,
            allow_random_init=True, arch=ARCH, device="cpu")
    finally:
        if old is None:
            del os.environ["HF_HUB_OFFLINE"]
        else:
            os.environ["HF_HUB_OFFLINE"] = old
    assert out == d
    return d, _bundle(0), load_predict_artifact(d, device="cpu")


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, S, S, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, S, S, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, S, S, 1), dtype=np.uint8))


def _in_process(bundle, batch, seed, mask=None, mc_chunk=None):
    step = make_packed_predict_step(bundle, MC, mc_chunk=mc_chunk)
    n = batch[0].shape[0]
    mask = torch.ones(n) if mask is None else torch.as_tensor(mask)
    out = step(bundle.post, bundle.batch_stats,
               tuple(torch.from_numpy(a) for a in batch),
               torch.Generator().manual_seed(seed), mask)
    return {k: v.numpy() for k, v in out.items()}


def test_artifact_roundtrip_exact(artifact):
    """The artifact's outputs equal the in-process step's bit for bit at the
    same seeds (a generator seeded alike on both sides)."""
    _, bundle, art = artifact
    m, b, s = _batch()
    assert art.meta["platforms"] == ["cpu"] and art.mc_chunk == 2
    out = art.predict(m, b, s, key=torch.Generator().manual_seed(7))
    ref = _in_process(bundle, (m, b, s), 7)
    np.testing.assert_array_equal(out["predicted"], ref["predicted"])
    np.testing.assert_array_equal(out["csv_cols"], ref["csv_cols"])
    np.testing.assert_array_equal(out["mean_prob"], ref["mean_prob"])
    # an int key is the seed of the generator
    np.testing.assert_array_equal(art.predict(m, b, s, key=7)["csv_cols"],
                                  out["csv_cols"])


def test_artifact_deterministic_and_mask(artifact):
    """Repeat calls with one key are equal; masked rows do not change the
    real rows' outputs (the masked train-mode BN), to f32 roundoff: 1e-6
    absolute on mean_prob, since the padded rows' values enter the masked
    sums as exact zeros but the sums' order is the library's."""
    _, _, art = artifact
    m, b, s = _batch(1)
    o1 = art.predict(m, b, s, key=3)
    o2 = art.predict(m, b, s, key=3)
    np.testing.assert_array_equal(o1["csv_cols"], o2["csv_cols"])
    mask = np.array([1, 1, 0, 0], np.float32)
    m2, b2, s2 = (a.copy() for a in (m, b, s))
    m2[2:], b2[2:], s2[2:] = 0, 0, 0
    om = art.predict(m2, b2, s2, key=3, mask=mask)
    m3, b3, s3 = (a.copy() for a in (m, b, s))
    m3[2:], b3[2:], s3[2:] = 255, 255, 255
    om2 = art.predict(m3, b3, s3, key=3, mask=mask)
    np.testing.assert_allclose(om["mean_prob"][:2], om2["mean_prob"][:2],
                               rtol=0, atol=1e-6)


def test_artifact_input_validation(artifact):
    _, _, art = artifact
    m, b, s = _batch()
    with pytest.raises(ValueError, match="batch shape"):
        art.predict(m[:2], b[:2], s[:2])
    with pytest.raises(ValueError, match="uint8"):
        art.predict(m.astype(np.float32), b, s)
    with pytest.raises(ValueError, match="int seed or a torch.Generator"):
        art.predict(m, b, s, key=np.zeros((1, 2), np.int64))


def test_artifact_version_gate(artifact, tmp_path):
    d, _, _ = artifact
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    meta = json.loads((bad / "meta.json").read_text())
    meta["version"] = ARTIFACT_VERSION + 1
    (bad / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="version"):
        load_predict_artifact(str(bad), device="cpu")


def test_artifact_integrity_check(artifact, tmp_path):
    """meta.json records the sha256 of both programs and the state; a
    flipped byte in the state file or a program is refused at load."""
    d, _, _ = artifact
    for name in ("state.npz", "program.pt2", "reduce.pt2"):
        bad = tmp_path / name
        shutil.copytree(d, bad)
        raw = bytearray((bad / name).read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (bad / name).write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="integrity check failed"):
            load_predict_artifact(str(bad), device="cpu")


def test_predict_batches_lagged_stream(artifact):
    """predict_batches yields, in order, what per-batch predict gives with
    the matching folded seeds."""
    _, _, art = artifact
    batches = [_batch(i) for i in range(3)]
    streamed = list(art.predict_batches(iter(batches), key=11))
    assert len(streamed) == 3
    for i, (got, b) in enumerate(zip(streamed, batches)):
        ref = art.predict(*b, key=fold_seed(11, i))
        np.testing.assert_array_equal(got["csv_cols"], ref["csv_cols"])


def test_predict_batches_ragged_mask(artifact):
    """4-tuple stream entries carry a validity mask; a masked batch equals
    predict with that mask and its folded seed."""
    _, _, art = artifact
    m, b, s = _batch(9)
    full_mask = np.ones((B,), np.float32)
    tail_mask = np.array([1, 1, 0, 0], np.float32)
    outs = list(art.predict_batches(
        [(m, b, s, full_mask), (m, b, s, tail_mask)], key=21))
    ref0 = art.predict(m, b, s, key=fold_seed(21, 0), mask=full_mask)
    ref1 = art.predict(m, b, s, key=fold_seed(21, 1), mask=tail_mask)
    np.testing.assert_array_equal(outs[0]["csv_cols"], ref0["csv_cols"])
    np.testing.assert_array_equal(outs[1]["csv_cols"], ref1["csv_cols"])
    assert outs[1]["mean_prob"].shape == (B, C)


def test_keyless_predict_draws_fresh_samples(artifact):
    """predict(key=None) folds a per-artifact call counter into the export
    seed: repeated keyless calls draw fresh samples, and call i equals
    keyless predict_batches' batch i (on a copy of the loaded artifact
    whose counter starts at 0, as after a load)."""
    import copy

    _, _, art = artifact
    fresh = copy.copy(art)
    fresh._num_calls = 0
    m, b, s = _batch(5)
    o0 = fresh.predict(m, b, s)
    o1 = fresh.predict(m, b, s)
    assert np.abs(o0["mean_prob"] - o1["mean_prob"]).max() > 0
    streamed = list(art.predict_batches(iter([(m, b, s), (m, b, s)])))
    np.testing.assert_array_equal(o0["csv_cols"], streamed[0]["csv_cols"])
    np.testing.assert_array_equal(o1["csv_cols"], streamed[1]["csv_cols"])


def test_polymorphic_batch_artifact(artifact, tmp_path):
    """batch_size='poly' exports one artifact that serves any batch size,
    bit-exact against the in-process step at each size (1, 2, 5, 4), in
    chunks of one draw (the static artifact's are two)."""
    _, bundle, _ = artifact
    d = str(tmp_path / "poly")
    export_predict_artifact(bundle, d, batch_size="poly", num_mc_samples=MC,
                            image_size=S, mc_chunk=1)
    art = load_predict_artifact(d, device="cpu")
    assert art.batch_size == "poly" and art.nchunks == MC
    for n in (1, 2, 5, B):
        batch = _batch(3 + n, n)
        out = art.predict(*batch, key=9)
        ref = _in_process(bundle, batch, 9, mc_chunk=1)
        np.testing.assert_array_equal(out["csv_cols"], ref["csv_cols"])
        np.testing.assert_array_equal(out["mean_prob"], ref["mean_prob"])


def test_refusals_name_their_items(artifact, tmp_path):
    """Batch-sharded exports are not ported yet and raise naming ROADMAP
    item 8b; so do a batch-sharded artifact's load and the pipeline's
    shard flag (mc-sharded artifacts are ported:
    tests/test_torch_serving_mc_shards.py); platforms other than the
    bundle's device and an unknown mode are refused; an artifact refuses a
    device of another type than it was exported on."""
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact

    d, bundle, _ = artifact
    kw = dict(batch_size=B, num_mc_samples=MC, image_size=S)
    with pytest.raises(NotImplementedError, match="item 8b"):
        export_predict_artifact(bundle, str(tmp_path / "x"), data_shards=2,
                                **kw)
    with pytest.raises(NotImplementedError, match="item 8b"):
        export_auv_serving_artifact(str(tmp_path / "x"), data_shards=2)
    with pytest.raises(ValueError, match="mode"):
        export_predict_artifact(bundle, str(tmp_path / "x"), mode="x", **kw)
    with pytest.raises(ValueError, match="platforms"):
        export_predict_artifact(bundle, str(tmp_path / "x"),
                                platforms=["cuda"], **kw)
    for change, err, match in (({"data_shards": 2}, NotImplementedError,
                                "item 8b"),
                               ({"platforms": ["cuda"]}, ValueError,
                                "exported for")):
        bad = tmp_path / f"meta_{next(iter(change))}"
        bad.mkdir()
        meta = json.loads(open(os.path.join(d, "meta.json")).read())
        (bad / "meta.json").write_text(json.dumps({**meta, **change}))
        with pytest.raises(err, match=match):
            load_predict_artifact(str(bad), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_predict_artifact(d)  # device=None is the card


def test_loader_needs_no_model_code(artifact):
    """Loading and predicting runs in a process where the port's model,
    engine and posterior modules (and JAX) are never imported, proven by
    an import tripwire in a subprocess."""
    d, _, _ = artifact
    code = f"""
import builtins, sys
_real = builtins.__import__
FORBIDDEN = ("jax", "multimodal_auv_tpu", "multimodal_auv_torch.models",
             "multimodal_auv_torch.engine", "multimodal_auv_torch.bayes")
def guard(name, *a, **k):
    if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
        raise ImportError("forbidden in serving process: " + name)
    return _real(name, *a, **k)
builtins.__import__ = guard
sys.path.insert(0, {REPO!r})
import numpy as np
from multimodal_auv_torch.serving import load_predict_artifact
art = load_predict_artifact({d!r}, device="cpu")
rng = np.random.default_rng(0)
out = art.predict(rng.integers(0, 255, ({B},{S},{S},3), dtype=np.uint8),
                  rng.integers(0, 255, ({B},{S},{S},3), dtype=np.uint8),
                  rng.integers(0, 255, ({B},{S},{S},1), dtype=np.uint8))
assert out["predicted"].shape == ({B},)
assert not [m for m in sys.modules if m.startswith(FORBIDDEN)]
print("SERVE_OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "SERVE_OK" in r.stdout


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX package's own artifact of a micro() posterior with rho = -30
    everywhere (sigma ~ 1e-13: every draw is the posterior mean in bf16),
    and the JAX bundle."""
    jb = jmake(C, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    jb.post = jb.post.replace(rho=jnp.full_like(jb.post.rho, -30.0))
    d = str(tmp_path_factory.mktemp("jax_artifact"))
    jax_export(jb, d, batch_size=B, num_mc_samples=MC, image_size=S)
    return d, jb


def test_meta_keys_equal_jax(artifact, jax_artifact):
    """meta.json has the JAX artifact's keys and ``torch_version`` (the
    port's programs are torch.export's serialisation, which the loader
    reads only under the release that wrote it); only the digests' file
    names differ (two programs and the state)."""
    (d, _, _), (jd, _) = artifact, jax_artifact
    ours = json.loads(open(os.path.join(d, "meta.json")).read())
    theirs = json.loads(open(os.path.join(jd, "meta.json")).read())
    assert set(ours) == set(theirs) | {"torch_version"}
    assert set(ours["sha256"]) == {"program.pt2", "reduce.pt2", "state.npz"}


def test_artifact_equals_jax_artifact_at_posterior_mean(jax_artifact,
                                                        tmp_path):
    """The same posterior carried to the port (rho = -30, so each draw is
    the bf16 posterior mean in both packages, whatever their noise):
    the port's artifact against the JAX package's artifact on the same
    batch. Predicted classes equal; mean_prob and the aleatoric entropy to
    1e-5 absolute (f32 forwards over the same bf16 weights, reductions in
    another order); the predictive variance ~0 in both, to 1e-6."""
    jd, jb = jax_artifact
    tb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  jax.tree_util.tree_map(np.asarray, jb.post.det),
                  jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=C, arch=ARCH, device="cpu")
    d = str(tmp_path / "port")
    export_predict_artifact(tb, d, batch_size=B, num_mc_samples=MC,
                            image_size=S, mc_chunk=1)
    art = load_predict_artifact(d, device="cpu")
    batch = _batch(17)
    got = art.predict(*batch, key=0)
    want = jax_load(jd).predict(*batch, key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got["predicted"], want["predicted"])
    np.testing.assert_allclose(got["mean_prob"], want["mean_prob"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["aleatoric_uncertainty"],
                               want["aleatoric_uncertainty"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["predictive_uncertainty"],
                               want["predictive_uncertainty"], rtol=0,
                               atol=1e-6)
    assert got["aleatoric_uncertainty"].min() > 0.5  # not degenerate
