"""The JAX package's public names that the port carries, each held against
its JAX counterpart on the same inputs: the package and subpackage
exports, ``config.load_yaml``, ``define_optimizers_and_schedulers``, the
train step's ``update_batch_stats``, ``multimodal_predict_and_save``'s
reference knobs, ``encode_labels``, ``resnet50``, ``hf_manifest.main``
and the console scripts.
"""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("engine", "bayes", "ops", "utils", "parallel")
# the JAX package's parallel exports without a torch counterpart
# (jax.sharding objects; parallel/mesh.py's docstring)
NOT_PORTED = {"batch_sharding", "replicated", "shard_batch", "mc_sharding"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_exports(sub: str) -> set:
    jmod = importlib.import_module(f"multimodal_auv_tpu.{sub}")
    return {n for n in vars(jmod) if not n.startswith("_")
            and not isinstance(getattr(jmod, n), type(sys))}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    """Each subpackage exports the JAX package's names (parallel: those
    with a torch counterpart), each resolving to the port's object."""
    mod = importlib.import_module(f"multimodal_auv_torch.{sub}")
    want = _jax_exports(sub) - (NOT_PORTED if sub == "parallel" else set())
    assert set(mod.__all__) == want
    for name in mod.__all__:
        obj = getattr(mod, name)
        assert obj.__module__.startswith("multimodal_auv_torch."), name
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_package_exports_the_pipelines():
    """``from multimodal_auv_torch import run_auv_inference`` and the other
    three reference names, as the JAX package exports them."""
    import multimodal_auv_tpu
    import multimodal_auv_torch
    from multimodal_auv_torch import pipelines

    assert multimodal_auv_torch.__all__ == multimodal_auv_tpu.__all__
    for name in multimodal_auv_torch.__all__:
        assert getattr(multimodal_auv_torch, name) is getattr(pipelines, name)
    from multimodal_auv_torch import run_auv_inference  # noqa: F401


@pytest.mark.parametrize("text", [None, (
    "num_classes: 5\nbnn:\n  moped_delta: 0.2\ntraining:\n  num_mc: 7\n"
    "mesh:\n  fsdp: true\nscheduler:\n  gamma: 0.5\nsss_patch_type: null\n"
    "trainng:\n  num_epochs: 3\n")], ids=["config.yaml", "overrides"])
def test_load_yaml_equals_jax(tmp_path, caplog, text):
    """The repo's config.yaml, and overrides with an unknown section: the
    port's ``RunConfig`` equals JAX's field for field; the unknown key is
    a warning in both."""
    from multimodal_auv_torch.config import RunConfig, load_yaml
    from multimodal_auv_tpu.config import load_yaml as jload_yaml

    path = os.path.join(REPO, "config.yaml")
    if text is not None:
        path = str(tmp_path / "c.yaml")
        with open(path, "w") as f:
            f.write(text)
    got, want = load_yaml(path), jload_yaml(path)
    assert isinstance(got, RunConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    if text is not None:
        assert got.training.num_mc == 7 and got.mesh.fsdp is True
        assert sum("unknown key 'trainng'" in r.getMessage()
                   for r in caplog.records) == 2


def test_define_optimizers_and_schedulers_equals_jax():
    """The reference's param dicts give each model JAX's Adam knobs and
    JAX's learning rate at every epoch of the schedule (both steps of each
    epoch); a model with no entries takes the specs' defaults."""
    from multimodal_auv_torch.engine import define_optimizers_and_schedulers
    from multimodal_auv_tpu.engine import (
        define_optimizers_and_schedulers as jdefine,
    )

    names = ["multimodal_model", "image_model", "sss_model"]
    opt = {"multimodal_model": {"lr": 3e-4, "weight_decay": 1e-4},
           "image_model": {"lr": 1e-3}}
    sched = {"multimodal_model": {"step_size": 3, "gamma": 0.5},
             "sss_model": {"gamma": 0.9}}
    got, want = (define_optimizers_and_schedulers(names, opt, sched),
                 jdefine(names, opt, sched))
    assert list(got) == list(want) == names
    for name in names:
        g, w = got[name], want[name]
        tx_state = w.tx.init(jnp.zeros(3))
        # JAX injects its learning rate as an f32 array
        assert np.float32(g.tx.lr) == tx_state.hyperparams["learning_rate"]
        assert g.tx.weight_decay == float(opt.get(name, {}).get(
            "weight_decay", 1e-5))
        for _ in range(40):
            assert g.scheduler.lr == w.scheduler.lr
            g.scheduler.step()
            w.scheduler.step()
    # the Adam the port's definition builds takes those knobs
    from multimodal_auv_torch.bayes.packing import PackedPosterior

    post = PackedPosterior(torch.zeros(4), torch.zeros(4), {})
    adam = got["multimodal_model"].tx.init(post)
    assert adam.param_groups[0]["lr"] == 3e-4
    assert adam.param_groups[0]["weight_decay"] == 1e-4


def test_train_step_update_batch_stats_false(monkeypatch):
    """``make_train_step(update_batch_stats=False)``: the running
    statistics come back bit-unchanged, and the step holds against JAX's
    step with the same flag under injected eps (loss, CE and scaled KL to
    rtol 1e-4, the same predictions; JAX's statistics unchanged too);
    with the flag on the statistics move."""
    import multimodal_auv_torch.ops.sampling as torch_sampling
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.mc import chunk_seeds
    from multimodal_auv_torch.engine.optim import (
        BayesTrainState,
        make_optimizer,
    )
    from multimodal_auv_torch.engine.steps import make_train_step
    from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
    from multimodal_auv_tpu.engine.optim import BayesTrainState as JState
    from multimodal_auv_tpu.engine.optim import make_optimizer as jmake_opt
    from multimodal_auv_tpu.engine.steps import make_train_step as jmake_step
    from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
    from multimodal_auv_tpu.models.model_utils import (
        make_multimodal_bundle as jmake,
    )
    from tests.test_torch_train import _leaves_with_paths, _np_tree, _port_bundle

    num_mc = 2
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    pb = _port_bundle(jb)
    rng = np.random.default_rng(8)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    labels = np.array([0, 3, 5], np.int32)
    mask = np.ones(3, np.float32)
    key = jax.random.PRNGKey(4)
    seeds = chunk_seeds(torch.Generator().manual_seed(2), num_mc)
    chunk_keys = dict(zip(seeds, jax.random.split(key, num_mc)))

    def jax_eps(P_, seed, num_draws, device=None, noise="f32"):
        eps = jax.random.normal(chunk_keys[tuple(seed)], (num_draws, P_),
                                jnp.float32)
        return torch.from_numpy(np.array(eps)).to(device)

    monkeypatch.setattr(torch_sampling, "eps_plain", jax_eps)
    tx = jmake_opt(1e-3, 1e-5)
    jstep = jmake_step(jb.module, jb.meta, JSpec(), tx, num_mc, impl="jnp",
                       packed_inputs=True, update_batch_stats=False)
    jstate = JState(post=jb.post, opt_state=tx.init(jb.post),
                    batch_stats=jb.batch_stats,
                    step=jnp.zeros((), jnp.int32))
    jstate2, jm = jstep(jstate, tuple(jnp.asarray(a) for a in u8),
                        jnp.asarray(labels), jnp.asarray(mask), key, 1e-6,
                        3.0)

    before = {p: v.clone() for p, v in _leaves_with_paths(pb.batch_stats)}
    for flag in (False, True):
        state = BayesTrainState(pb.post, make_optimizer(1e-3, 1e-5).init(
            pb.post), pb.batch_stats)
        step = make_train_step(pb.module, pb.meta, BNNPriorSpec(), num_mc,
                               packed_inputs=True, update_batch_stats=flag)
        state, m = step(state, [torch.from_numpy(a) for a in u8],
                        torch.from_numpy(labels), torch.from_numpy(mask),
                        torch.Generator().manual_seed(2), 1e-6, 3.0)
        after = dict(_leaves_with_paths(state.batch_stats))
        same = all(torch.equal(before[p], after[p]) for p in before)
        assert same is not flag
        if flag:
            break
        assert state.step == 1 and not m["skipped"]
        for name in ("loss", "cross_entropy", "scaled_kl"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=name)
        np.testing.assert_array_equal(m["predicted"].numpy(),
                                      np.asarray(jm["predicted"]))
        jbs = dict(_leaves_with_paths(_np_tree(jstate2.batch_stats)))
        for path, leaf in _leaves_with_paths(_np_tree(jb.batch_stats)):
            np.testing.assert_array_equal(jbs[path], leaf)
        # the posterior trained: mu moved
        assert not torch.equal(state.post.mu, torch.from_numpy(
            np.array(jb.post.mu)))


def test_multimodal_predict_and_save_takes_the_reference_knobs(tmp_path):
    """``sss_patch_type``, ``channel_patch_type`` and ``model_type`` are
    accepted and change nothing, as in the JAX package."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.data.loaders import prepare_inference_dataloader
    from multimodal_auv_torch.engine.predict import multimodal_predict_and_save
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from tests.fixtures.make_tree import make_inference_tree

    root = make_inference_tree(str(tmp_path / "dives"), n_samples=3)
    bundle = make_multimodal_bundle(7, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cpu")
    out = {}
    for name, kw in (("plain", {}), ("knobs", dict(
            sss_patch_type="patch_30_sss", channel_patch_type="patch_30_bathy",
            model_type="multimodal"))):
        loader = prepare_inference_dataloader(root, 2, image_size=32)
        out[name] = str(tmp_path / f"{name}.csv")
        multimodal_predict_and_save(bundle, loader, out[name], 2,
                                    device="cpu", **kw)
    assert open(out["plain"]).read() == open(out["knobs"]).read()
    assert len(open(out["plain"]).read().splitlines()) == 4


def test_encode_labels_equals_jax():
    from multimodal_auv_torch.data.loaders import encode_labels
    from multimodal_auv_tpu.data.loaders import encode_labels as jencode

    labels = ["Rock", "Sand", "Mud", "Sand", "Kelp forest", "Rock"]
    codes, enc = encode_labels(labels)
    jcodes, jenc = jencode(labels)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(enc.classes_, jenc.classes_)
    np.testing.assert_array_equal(enc.inverse_transform(codes), labels)


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], path + (k,))
    else:
        yield path, tuple(tree.shape)


@pytest.mark.parametrize("num_classes,cin", [(None, 3), (5, 1)])
def test_resnet50_builds_jax_parameter_shapes(num_classes, cin):
    """``resnet50`` at two stages and width 8: the port's parameter tree
    (the JAX layout) has JAX's paths and shapes; the forward gives the
    features or logits JAX's gives in shape."""
    from multimodal_auv_torch.models.resnet import resnet50
    from multimodal_auv_tpu.models.resnet import resnet50 as jresnet50

    kw = dict(width=8, stage_sizes=(1, 1))
    jmod = jresnet50(num_classes, **kw)
    x = jnp.zeros((2, 32, 32, cin))
    jvars = jmod.init(jax.random.PRNGKey(0), x, train=False)
    mod = resnet50(num_classes, **kw)
    params, stats = mod.init(torch.Generator().manual_seed(0), cin)
    assert dict(_shapes(params)) == dict(_shapes(jax.tree_util.tree_map(
        np.asarray, jvars["params"])))
    from multimodal_auv_torch.models.resnet import forward_layout

    out = mod(forward_layout(params), stats, torch.zeros(2, 32, 32, cin),
              train=False)
    assert tuple(out.shape) == jmod.apply(jvars, x, train=False).shape
    with pytest.raises(ValueError, match="param_dtype"):
        resnet50(param_dtype=torch.bfloat16)


def test_hf_manifest_main(tmp_path, monkeypatch, capsys):
    """``main`` audits a checkpoint as the JAX package's does (the same
    verdict and exit code on a file with every inventory key, and on one
    lacking a loadable key); ``--write-manifest`` regenerates the shipped
    inventory byte for byte; no argument is exit 2."""
    from multimodal_auv_torch.interop import hf_manifest
    from multimodal_auv_tpu.interop import hf_manifest as jhf

    expected = hf_manifest.load_manifest()
    full = {k: torch.zeros(()) for k in expected}
    path = str(tmp_path / "full.bin")
    torch.save(full, path)
    lacking = dict(full)
    del lacking[next(k for k, v in expected.items()
                     if v["role"] == "mu")]
    path2 = str(tmp_path / "lacking.bin")
    torch.save(lacking, path2)
    for p, rc, verdict in ((path, 0, "COVERAGE OK"),
                           (path2, 1, "COVERAGE INCOMPLETE")):
        assert hf_manifest.main([p]) == rc
        assert capsys.readouterr().out.strip().splitlines()[-1] == verdict
        assert jhf.main([p]) == rc
        assert capsys.readouterr().out.strip().splitlines()[-1] == verdict
    assert hf_manifest.main([]) == 2

    shipped = open(hf_manifest.MANIFEST_PATH, "rb").read()
    out = str(tmp_path / "expected_hf_keys.json")
    monkeypatch.setattr(hf_manifest, "MANIFEST_PATH", out)
    assert hf_manifest.main(["--write-manifest"]) == 0
    assert open(out, "rb").read() == shipped


def test_console_scripts_resolve():
    """Every ``multimodal-auv-torch-*`` script of pyproject.toml resolves
    to a callable of the port, one beside each of the JAX package's
    pipeline scripts."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    torch_scripts = {k: v for k, v in scripts.items()
                     if k.startswith("multimodal-auv-torch-")}
    assert set(torch_scripts) == {
        f"multimodal-auv-torch-{n}" for n in (
            "data-prep", "inference", "retrain", "train-scratch",
            "export-serving", "selfcheck", "serve", "data-check")}
    for name, target in torch_scripts.items():
        module, attr = target.split(":")
        assert module.startswith("multimodal_auv_torch.")
        assert callable(getattr(importlib.import_module(module), attr)), name
        jname = name.replace("multimodal-auv-torch-", "multimodal-auv-")
        assert scripts[jname].split(":")[1] == attr
