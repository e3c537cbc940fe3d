"""The port's unimodal family against the JAX package's: the folder scan's
skip rule, ``ResNet50Custom``, ``define_models``, one unimodal train step,
the unimodal epoch loops, and the unimodal pipelines.

Weights go across as numpy through interop/from_jax.py. The TPU's noise
cannot be reproduced, so where a test compares stochastic outputs the
port's one eps function (or both packages' samplers) is replaced, in that
test only, by the same draws.
"""
import csv
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.data.transforms as torch_T
import multimodal_auv_torch.engine.mc as torch_mc
import multimodal_auv_torch.ops.sampling as torch_sampling
import multimodal_auv_tpu.data.transforms as jax_T
import multimodal_auv_tpu.engine.loops as jax_loops
import multimodal_auv_tpu.engine.mc as jax_mc
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.datasets import (
    InferenceFolderDataset,
    MultimodalFolderDataset,
)
from multimodal_auv_torch.engine import loops
from multimodal_auv_torch.engine.mc import chunk_seeds
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.engine.steps import make_train_step
from multimodal_auv_torch.interop.from_jax import from_jax, trunk_from_jax
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    ModelBundle,
    define_models,
    load_models,
    move_models_to_device,
)
from multimodal_auv_torch.pipelines.unimodal import (
    run_unimodal_training,
    unimodal_predict_and_save,
)
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.data.datasets import (
    InferenceFolderDataset as JInferenceFolderDataset,
)
from multimodal_auv_tpu.data.datasets import (
    MultimodalFolderDataset as JMultimodalFolderDataset,
)
from multimodal_auv_tpu.engine.optim import BayesTrainState as JState
from multimodal_auv_tpu.engine.optim import make_optimizer as jmake_optimizer
from multimodal_auv_tpu.engine.steps import make_elbo_loss_fn as jelbo
from multimodal_auv_tpu.engine.steps import make_train_step as jmake_train_step
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import define_models as jdefine
from multimodal_auv_tpu.models.model_utils import make_unimodal_bundle as jmake
from multimodal_auv_tpu.pipelines.unimodal import (
    unimodal_predict_and_save as jax_unimodal_predict,
)
from tests.fixtures.make_tree import make_inference_tree, make_training_tree


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _entries(meta):
    return [(e.path, e.shape, e.offset, e.size) for e in meta.entries]


def _port(jb, channels, arch):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                    _entries(jb.meta), num_classes=7, arch=arch,
                    kind=("unimodal", channels), device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# -- the folder scan skips what the JAX package skips -------------------------

def test_scan_skips_what_jax_skips(tmp_path, monkeypatch):
    """An SSS probe that raises something other than OSError or ValueError
    (here RuntimeError, as PIL's decompression-bomb guard or a missing PIL
    would) skips that folder in both packages: the same surviving samples,
    labelled and unlabelled."""
    train = make_training_tree(str(tmp_path / "train"), n_samples=5)
    infer = make_inference_tree(str(tmp_path / "infer"), n_samples=5)
    real = {m: m.image_nonzero_count for m in (torch_T, jax_T)}

    def probe(mod):
        def f(path, mode=None):
            if "_002" in os.path.dirname(path):
                raise RuntimeError("image too large to decode")
            return real[mod](path, mode)
        return f

    for mod in (torch_T, jax_T):
        monkeypatch.setattr(mod, "image_nonzero_count", probe(mod))
    got = sorted(os.path.basename(p["main_image"])
                 for p in MultimodalFolderDataset(train, 32).data_paths)
    want = sorted(os.path.basename(p["main_image"])
                  for p in JMultimodalFolderDataset(
                      train, image_size=32).data_paths)
    assert got == want and len(got) == 4 and "frame_0002.jpg" not in got
    got = sorted(os.path.basename(d["main_image"])
                 for d in InferenceFolderDataset(infer, 32).data)
    want = sorted(os.path.basename(d["main_image"])
                  for d in JInferenceFolderDataset(infer, image_size=32).data)
    assert got == want and len(got) == 4 and "Frame_0002.jpg" not in got


# -- ResNet50Custom -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_unimodal():
    out = {}
    for c in (1, 3):
        jb = jmake(c, 7, JSpec(), jax.random.PRNGKey(c), JArch.tiny())
        out[c] = (jb, _port(jb, c, ArchConfig.tiny()))
    return out


@pytest.mark.parametrize("mode", ["train", "train_masked", "eval"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resnet50custom_forward_equals_flax(tiny_unimodal, channels, mode):
    """Logits of the same flat w through flax's and the port's
    ``ResNet50Custom`` at tiny(), f32, 64 px, batch 3, rtol 1e-4 / atol 1e-5
    (tests/test_torch_models.py's tolerance and its reason for 64 px); the
    parameter tree sits under ``model`` as flax's does. The masked case
    (mask [1, 1, 0]) compares the real rows, and the new running
    statistics of ``mutable`` to atol 1e-5."""
    jb, pb = tiny_unimodal[channels]
    assert all(e.path[0] == "model" for e in pb.meta.entries)
    assert pb.module.get_feature_size() == jb.module.get_feature_size()
    rng = np.random.default_rng(channels)
    w = (np.asarray(jb.post.mu)
         + 0.05 * rng.standard_normal(pb.meta.n_padded)).astype(np.float32)
    x = rng.standard_normal((3, 64, 64, channels)).astype(np.float32)
    params = jb.meta.unpack(jnp.asarray(w), jb.post.det)
    mask = np.array([1, 1, 0], bool) if mode == "train_masked" else None
    if mode == "eval":
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: (np.abs(rng.standard_normal(a.shape)) * 0.1 + 0.5
                          if p[-1].key == "var"
                          else rng.standard_normal(a.shape) * 0.1
                          ).astype(np.float32), _np_tree(jb.batch_stats))
        want = jb.module.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=False)
        with torch.no_grad():
            got = pb.apply_with_weights(
                torch.from_numpy(w), torch.from_numpy(x), train=False,
                batch_stats=jax.tree_util.tree_map(torch.from_numpy, stats))
        rows = slice(None)
    else:
        want, jnew = jb.module.apply(
            {"params": params, "batch_stats": jb.batch_stats},
            jnp.asarray(x), train=True,
            batch_mask=None if mask is None else jnp.asarray(mask, jnp.float32),
            mutable=["batch_stats"])
        with torch.no_grad():
            got, new = pb.apply_with_weights(
                torch.from_numpy(w), torch.from_numpy(x), train=True,
                batch_mask=None if mask is None else torch.from_numpy(mask),
                mutable=True)
        rows = slice(0, 2) if mask is not None else slice(None)
        jstats = dict(_leaves(_np_tree(jnew["batch_stats"])))
        tstats = dict(_leaves(new))
        assert sorted(jstats) == sorted(tstats)
        for k, v in tstats.items():
            np.testing.assert_allclose(v.numpy(), jstats[k], rtol=0,
                                       atol=1e-5, err_msg=str(k))
    want, got = np.asarray(want)[rows], got.numpy()[rows]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- define_models ---------------------------------------------------------------

def test_define_models_layout_equals_jax(tmp_path, caplog):
    """At tiny(): the seven keys, every Bayesian bundle's packing entries and
    lengths, and every feature trunk's parameter paths and shapes equal
    the JAX package's; each Bayesian entry is a ``ModelBundle`` on the
    asked device. ``load_models`` warns and keeps the random init for a
    missing path, and logs a file that does not load and keeps the random
    init; so does ``pretrained_paths`` for a file it cannot load."""
    jm = jdefine(7, JSpec().to_dict(), jax.random.PRNGKey(0), JArch.tiny())
    tm = define_models(7, BNNPriorSpec().to_dict(),
                       torch.Generator().manual_seed(0), ArchConfig.tiny(),
                       device="cpu")
    assert list(tm) == list(jm)
    for name, jv in jm.items():
        tv = tm[name]
        if name.endswith("_feat"):
            channels = 1 if name.startswith("sss") else 3
            trunk = trunk_from_jax(_np_tree(jv["variables"]),
                                   input_channels=channels,
                                   arch=ArchConfig.tiny(), device="cpu")
            shapes = lambda t: {k: tuple(v.shape) for k, v in _leaves(t)}
            assert shapes(trunk["variables"]) == shapes(tv["variables"])
            x = torch.zeros(2, 32, 32, channels)
            feats = tv["module"](tv["variables"]["params"],
                                 tv["variables"]["batch_stats"], x,
                                 train=False)
            assert feats.shape == (2, jv["module"].feature_size)
        else:
            assert isinstance(tv, ModelBundle) and tv.device.type == "cpu"
            assert _entries(tv.meta) == _entries(jv.meta), name
            assert (tv.meta.n_real, tv.meta.n_padded) == (jv.meta.n_real,
                                                          jv.meta.n_padded)
    assert move_models_to_device(tm, device="cpu") is tm
    with caplog.at_level("WARNING"):
        trunks = load_models({"image": str(tmp_path / "nope")},
                             arch=ArchConfig.tiny(), device="cpu")
    assert len(trunks) == 3 and "Path not found" in caplog.text
    (tmp_path / "w.pt").write_bytes(b"")
    with caplog.at_level("ERROR"):
        kept = load_models({"sss": str(tmp_path / "w.pt")},
                           arch=ArchConfig.tiny(), device="cpu")
    assert "Failed to load sss model" in caplog.text
    assert torch.equal(kept[2]["variables"]["params"]["conv1"]["kernel"],
                       trunks[2]["variables"]["params"]["conv1"]["kernel"])
    with caplog.at_level("WARNING"):
        dm = define_models(7, BNNPriorSpec(), torch.Generator().manual_seed(0),
                           ArchConfig.tiny(), {"image": str(tmp_path / "w.pt")},
                           device="cpu")
    assert "Could not load pretrained trunk image" in caplog.text
    assert torch.equal(dm["image_model"].post.mu, tm["image_model"].post.mu)


# -- one train step ---------------------------------------------------------------

def test_one_unimodal_train_step_equals_jax(monkeypatch):
    """A micro() 1-channel (sss) ``ResNet50Custom``, batch 3 with a ragged
    tail (mask [1, 1, 0]), 32 px, 2 draws in chunks of 1, remat on, chained
    BN, kl_weight 1e-6, with the JAX chunk keys' eps injected as in
    tests/test_torch_train.py: loss, CE and scaled KL to rtol 1e-4, every
    mu, rho and BN-affine gradient to rtol 2e-2 with the leaf-scaled floor,
    the running statistics to atol 1e-5."""
    num_mc = 2
    jb = jmake(1, 7, JSpec(), jax.random.PRNGKey(7), JArch.micro())
    pb = _port(jb, 1, ArchConfig.micro())
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (3, 32, 32, 1)).astype(np.float32)
    labels = np.array([2, 5, 5], np.int32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(21)
    seeds = chunk_seeds(torch.Generator().manual_seed(4), num_mc)
    chunk_keys = dict(zip(seeds, jax.random.split(key, num_mc)))
    calls = []

    def jax_eps(P, seed, n, device=None, noise="f32"):
        calls.append(tuple(seed))
        eps = jax.random.normal(chunk_keys[tuple(seed)], (n, P), jnp.float32)
        return torch.from_numpy(np.array(eps)).to(device)

    monkeypatch.setattr(torch_sampling, "eps_plain", jax_eps)
    tx = jmake_optimizer(1e-3, 1e-5)
    jstep = jmake_train_step(jb.module, jb.meta, JSpec(), tx, num_mc,
                             impl="jnp")
    jstate = JState(post=jb.post, opt_state=tx.init(jb.post),
                    batch_stats=jb.batch_stats,
                    step=jnp.zeros((), jnp.int32))
    jargs = ((jnp.asarray(x),), jnp.asarray(labels), jnp.asarray(mask), key)
    jstate2, jm = jstep(jstate, *jargs, 1e-6, 3.0)
    _, jgrads = jax.jit(jax.value_and_grad(
        jelbo(jb.module, jb.meta, JSpec(), num_mc, impl="jnp"),
        has_aux=True))(jb.post, jb.batch_stats, *jargs, jnp.float32(1e-6),
                       jnp.float32(3.0))

    state = BayesTrainState(pb.post, make_optimizer(1e-3, 1e-5).init(pb.post),
                            pb.batch_stats)
    step = make_train_step(pb.module, pb.meta, BNNPriorSpec(), num_mc)
    state, m = step(state, [torch.from_numpy(x)], torch.from_numpy(labels),
                    torch.from_numpy(mask), torch.Generator().manual_seed(4),
                    1e-6, 3.0)
    assert sorted(calls) == sorted(seeds * 3)  # forward, re-forward, backward
    for name in ("loss", "cross_entropy", "scaled_kl"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(m["predicted"].numpy(),
                                  np.asarray(jm["predicted"]))

    def close(got, want, name):
        want = np.asarray(want)
        floor = 1e-3 * max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=floor,
                                   err_msg=name)

    for e in pb.meta.entries:
        sl = slice(e.offset, e.offset + e.size)
        close(pb.post.mu.grad.numpy()[sl], np.asarray(jgrads.mu)[sl],
              f"dmu{e.path}")
        close(pb.post.rho.grad.numpy()[sl], np.asarray(jgrads.rho)[sl],
              f"drho{e.path}")
    jdet = dict(_leaves(_np_tree(jgrads.det)))
    tdet = dict(_leaves(pb.post.det))
    assert sorted(jdet) == sorted(tdet) and len(tdet) > 10
    for path, leaf in tdet.items():
        close(leaf.grad.numpy(), jdet[path], f"ddet{path}")
    jbs = dict(_leaves(_np_tree(jstate2.batch_stats)))
    for path, leaf in _leaves(state.batch_stats):
        np.testing.assert_allclose(leaf.numpy(), jbs[path], rtol=0,
                                   atol=1e-5, err_msg=str(path))


# -- the epoch loops, on stub steps ---------------------------------------------

class _Loader:
    """Dict batches of 8x8 images, a ragged last batch."""

    def __init__(self, n, batch_size, seed):
        rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.x = rng.uniform(0, 1, (n, 8, 8, 1)).astype(np.float32)
        self.labels = rng.integers(0, 3, n).astype(np.int32)

    def __len__(self):
        return -(-len(self.labels) // self.batch_size)

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            sl = slice(i, i + self.batch_size)
            x = self.x[sl]
            yield {"main_image": x, "bathy_image": x, "sss_image": x,
                   "label": self.labels[sl]}


def _metrics(x, labels, mask, call):
    """Deterministic stand-ins for a step's numbers; call 1 has a NaN loss."""
    x, labels, mask = (np.asarray(a, np.float64) for a in (x, labels, mask))
    loss = float("nan") if call == 1 else float(x.mean()) + call
    pred = (x.reshape(len(x), -1).mean(axis=1) * 3).astype(np.int64) % 3
    correct = float(((pred == labels) * mask).sum())
    per = x.reshape(len(x), -1)[:, :2]
    return loss, pred, correct, float(mask.sum()), per[:, 0], per[:, 1]


class _Steps:
    """The same stub train and eval steps for both packages' loops."""

    def __init__(self):
        self.calls = 0

    def jax_train(self, state, inputs, labels, mask, key, kl_weight, nominal):
        loss, pred, correct, total, _, _ = _metrics(inputs[0], labels, mask,
                                                    self.calls)
        self.calls += 1
        return state, {"loss": loss, "correct": correct, "total": total}

    def torch_train(self, state, inputs, labels, mask, generator, kl_weight,
                    nominal):
        loss, pred, correct, total, _, _ = _metrics(inputs[0], labels, mask,
                                                    self.calls)
        self.calls += 1
        fused = np.concatenate([[loss, 0.0, kl_weight / nominal, correct,
                                 total, 0.0], pred])
        return state, {"fused": torch.tensor(fused, dtype=torch.float32),
                       "skipped": False, "predicted": torch.from_numpy(pred)}

    def jax_eval(self, post, bs, inputs, labels, mask, key, kl_scale):
        loss, pred, correct, total, epi, alea = _metrics(inputs[0], labels,
                                                         mask, 0)
        return {"loss": loss + kl_scale, "correct": correct, "total": total,
                "predicted": pred, "epistemic_variance": epi,
                "aleatoric_mc_entropy": alea}

    def torch_eval(self, post, bs, inputs, labels, mask, generator, kl_scale):
        loss, pred, correct, total, epi, alea = _metrics(inputs[0], labels,
                                                         mask, 0)
        b = len(pred)
        fused = np.concatenate([[loss + kl_scale, 0.0, kl_scale, correct,
                                 total], pred, np.zeros(3 * b), epi, alea,
                                np.zeros(b * 3)])
        return {"fused": torch.tensor(fused, dtype=torch.float32),
                "predicted": torch.from_numpy(pred)}


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


def test_unimodal_loops_equal_jax(tmp_path):
    """Both packages' unimodal orchestrators over the same stub steps and
    batches (7 samples in batches of 3, so a padded tail), 3 epochs: epoch
    0 is skipped by default, so each ledger holds epochs 2 and 3 (the row
    logs epoch + 1); the ledgers (the JAX package's columns, a NaN loss
    left out of the loss sum but not of the accuracy, the eval's
    variance-estimator and mean-entropy columns) and the TensorBoard
    scalars are equal; ``train_unimodal_model`` returns (state, accuracy,
    loss), the reverse of the multimodal loop's order."""
    train, test = _Loader(7, 3, 0), _Loader(5, 3, 1)
    runs = {}
    for pkg in ("jax", "torch"):
        steps, writer = _Steps(), _Writer()
        d = str(tmp_path / pkg / "csvs")
        if pkg == "jax":
            state = SimpleNamespace(
                post=None, batch_stats=None, opt_state=SimpleNamespace(
                    hyperparams={"learning_rate": jnp.float32(0)}))
            sched = jax_loops.StepLR(1e-3, 1, 0.5)
            jax_loops.train_and_evaluate_unimodal_model(
                train, test, 3, steps.jax_train, steps.jax_eval, state, sched,
                d, writer, jax.random.PRNGKey(0), model_type="sss",
                class_names=["a", "b", "c"])
        else:
            state = SimpleNamespace(
                post=SimpleNamespace(mu=torch.zeros(1)), batch_stats=None,
                opt_state=SimpleNamespace(param_groups=[{}]))
            sched = loops.StepLR(1e-3, 1, 0.5)
            loops.train_and_evaluate_unimodal_model(
                train, test, 3, steps.torch_train, steps.torch_eval, state,
                sched, d, writer, 0, model_type="sss",
                class_names=["a", "b", "c"])
        runs[pkg] = (d, writer.scalars, sched.epoch_count, steps.calls)
    (jd, jsc, jn, jcalls), (td, tsc, tn, tcalls) = runs["jax"], runs["torch"]
    assert jn == tn == 2 and jcalls == tcalls == 2 * len(train)
    for name, head in (("unimodal_sss_train_results.csv",
                        loops.UNIMODAL_TRAIN_CSV_HEADER),
                       ("unimodal_sss_eval_results.csv",
                        loops.UNIMODAL_EVAL_CSV_HEADER)):
        jrows = _read_csv(os.path.join(jd, name))
        trows = _read_csv(os.path.join(td, name))
        assert jrows[0] == trows[0] == head
        assert [r[:2] for r in trows[1:]] == [["2", "sss"], ["3", "sss"]]
        np.testing.assert_allclose(
            [[float(v) for v in r[2:]] for r in trows[1:]],
            [[float(v) for v in r[2:]] for r in jrows[1:]], rtol=1e-6)
    assert [(t, s) for t, _, s in tsc] == [(t, s) for t, _, s in jsc]
    np.testing.assert_allclose([v for _, v, _ in tsc], [v for _, v, _ in jsc],
                               rtol=1e-6)

    state = SimpleNamespace(post=SimpleNamespace(mu=torch.zeros(1)))
    steps = _Steps()
    out = loops.train_unimodal_model(
        steps.torch_train, state, train, 1, 3, str(tmp_path / "t.csv"),
        "sss", _Writer(), torch.Generator(), 1e-3)
    steps = _Steps()
    jout = jax_loops.train_unimodal_model(
        steps.jax_train, state, train, 1, 3, str(tmp_path / "j.csv"),
        "sss", _Writer(), jax.random.PRNGKey(0), 1e-3)
    assert out[0] is state and out[1] == pytest.approx(jout[1])
    assert out[2] == pytest.approx(jout[2])
    correct = sum(_metrics(b["sss_image"], b["label"], np.ones(len(
        b["label"])), 0)[2] for b in train)
    assert out[1] == pytest.approx(correct / 7)  # accuracy first


# -- the pipelines -----------------------------------------------------------------

def test_run_unimodal_training_cpu(tmp_path, monkeypatch):
    """Two epochs of ``run_unimodal_training`` on the CPU (micro(), 6
    samples: 4 train in batches of 2, 2 eval; 2 MC draws) for the optical
    image: epoch 0 is skipped, so one epoch runs, with both ledgers (one
    row each, epoch 2, finite numbers), the confusion-matrix CSV, the
    manifest, TensorBoard events and a resumable train state (2 steps).
    Resuming bathy, whose trunk has the image's shapes, from that state is
    refused; flags of paths not ported yet raise, naming their ROADMAP
    item."""
    monkeypatch.chdir(tmp_path)
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    state_path = str(tmp_path / "state.pt")
    kw = dict(num_epochs=2, num_mc=2, batch_size=2, arch=ArchConfig.micro(),
              handle_preemption=False, device="cpu",
              resume_checkpoint=state_path)
    mu0 = None

    def keep_first(bundle_fn):
        def wrapped(*a, **k):
            nonlocal mu0
            b = bundle_fn(*a, **k)
            mu0 = b.post.mu.clone()
            return b
        return wrapped

    import multimodal_auv_torch.pipelines.unimodal as pipeline
    monkeypatch.setattr(pipeline, "make_unimodal_bundle",
                        keep_first(pipeline.make_unimodal_bundle))
    state = run_unimodal_training(root, "image", **kw)
    assert state.step == 2 and not torch.equal(state.post.mu.detach(), mu0)
    csv_dir = os.path.join(root, "csvs")
    for name, head in (("unimodal_image_train_results.csv",
                        loops.UNIMODAL_TRAIN_CSV_HEADER),
                       ("unimodal_image_eval_results.csv",
                        loops.UNIMODAL_EVAL_CSV_HEADER)):
        rows = _read_csv(os.path.join(csv_dir, name))
        assert rows[0] == head and len(rows) == 2
        assert rows[1][:2] == ["2", "image"]
        assert np.isfinite([float(v) for v in rows[1][2:]]).all()
    assert os.listdir(os.path.join(csv_dir, "confusion_matrices"))
    assert os.path.exists(os.path.join(csv_dir, "run_manifest.json"))
    assert os.listdir(os.path.join(csv_dir, "tb"))
    saved = torch.load(state_path, weights_only=True)
    assert saved["epoch"] == 2 and saved["state"]["step"] == 2
    assert saved["meta"]["scheduler_counts"] == {"image": 1}
    with pytest.raises(ValueError, match="refusing to resume 'bathy'"):
        run_unimodal_training(root, "bathy", **kw)
    for flag, item in (({"async_checkpoints": True}, "async"),
                       ({"mesh_spec": object()}, "item 8"),
                       ({"dist_spec": object()}, "item 8"),
                       ({"mc_chunk": 5}, "training")):
        with pytest.raises(NotImplementedError, match=item):
            run_unimodal_training(root, "sss", device="cpu", **flag)


def test_unimodal_predict_csv_equals_jax(tmp_path, monkeypatch):
    """5 samples in batches of 2 (a ragged tail of 1, padded and masked), 4
    MC draws in one chunk, micro() 3-channel bundle carried from JAX, both
    packages' stacked samplers replaced by the same numpy draws: names and
    predicted classes equal, uncertainties to atol 1e-5 (f32 forwards,
    reductions in another order). Tuple and dict batches give the same
    CSV; the stacked kernel's path runs (no split sampling)."""
    jb = jmake(3, 7, JSpec(), jax.random.PRNGKey(5), JArch.micro())
    pb = _port(jb, 3, ArchConfig.micro())
    mu = np.asarray(jb.post.mu)
    sigma = np.asarray(jax.nn.softplus(jb.post.rho))
    rng = np.random.default_rng(3)
    draws = np.stack([mu + sigma * rng.standard_normal(mu.shape)
                      for _ in range(4)]).astype(np.float32)
    calls = {"jax": 0, "torch": 0}

    def jax_sampler(mu, sigma, key, num_draws=None, *, impl, out_dtype):
        assert num_draws == 4
        calls["jax"] += 1
        return jnp.asarray(draws)

    def torch_sampler(mu, sigma, seed, num_draws, *, out_dtype):
        assert num_draws == 4 and not torch.is_grad_enabled()
        calls["torch"] += 1
        return torch.from_numpy(draws)

    monkeypatch.setattr(jax_mc, "gaussian_shift_scale", jax_sampler)
    monkeypatch.setattr(torch_mc, "gaussian_shift_scale", torch_sampler)
    x = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    names = [f"frame_{i}.jpg" for i in range(5)]
    tuples = [(x[i:i + 2], x[i:i + 2], x[i:i + 2, ..., :1], names[i:i + 2])
              for i in range(0, 5, 2)]
    dicts = [{"main_image": t[0], "name": t[3]} for t in tuples]
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("jax", "t", "d")}
    jax_unimodal_predict(jb, tuples, paths["jax"], 4, mc_chunk=4)
    unimodal_predict_and_save(pb, tuples, paths["t"], 4, mc_chunk=4,
                              device="cpu")
    unimodal_predict_and_save(pb, dicts, paths["d"], 4, mc_chunk=4,
                              device="cpu")
    assert calls["jax"] == 1 and calls["torch"] == 6
    jrows, trows = _read_csv(paths["jax"]), _read_csv(paths["t"])
    assert trows == _read_csv(paths["d"])
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 6
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    got = np.array([[float(v) for v in r[2:]] for r in trows[1:]])
    want = np.array([[float(v) for v in r[2:]] for r in jrows[1:]])
    assert np.all(want[:, 1] > 1.0)  # a real, non-degenerate entropy
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
