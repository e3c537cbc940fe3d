"""The port's checkpoint interop against the JAX package's, on the same
inputs: the key mapping, the expected-key inventory, ``import_posterior``
(bayesian-torch dicts, the head swap, MOPED from deterministic dicts),
``export_posterior`` and files written by either package, the hub gate,
and ``define_models(pretrained_paths=...)`` / ``load_models``.

The port's bundles are carried from the JAX package's by
interop/from_jax.py, so both import into the same starting weights; the
imported leaves must then be equal bit for bit (both do the arithmetic in
numpy on the host).
"""
import filecmp
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.interop import hf_manifest, hub
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.interop.torch_export import (
    export_posterior,
    save_torch_checkpoint,
)
from multimodal_auv_torch.interop.torch_import import (
    import_posterior,
    load_and_prepare_multimodal_model,
    load_torch_state_dict,
    torch_key_to_flax,
)
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    define_models,
    load_models,
)
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.interop import hf_manifest as jmanifest
from multimodal_auv_tpu.interop import hub as jhub
from multimodal_auv_tpu.interop import torch_export as jexport
from multimodal_auv_tpu.interop import torch_import as jimport
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import define_models as jdefine
from multimodal_auv_tpu.models.model_utils import load_models as jload_models
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from tests.torch_twin import (
    TorchMultiModal,
    TorchResNetTrunk,
    bayesianize_state_dict,
)

TINY = ArchConfig.tiny()
JTINY = JArch.tiny()
TRUNKS = ("image_model_feat", "bathy_model_feat", "sss_model_feat")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def jax_bundles():
    """Tiny JAX multimodal bundles with 7 and 4 classes (built once)."""
    return {n: jmake(n, JSpec(), jax.random.PRNGKey(n), JTINY) for n in (7, 4)}


def _port(jb, num_classes):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                    [(e.path, e.shape, e.offset, e.size)
                     for e in jb.meta.entries],
                    num_classes=num_classes, arch=TINY, device="cpu")


def _assert_bit_equal(tpost, tbs, jpost, jbs, n=None):
    """mu and rho (their first ``n`` elements: a file holds no pad), every
    det and batch_stats leaf equal bit for bit."""
    for name in ("mu", "rho"):
        np.testing.assert_array_equal(getattr(tpost, name).numpy()[:n],
                                      np.asarray(getattr(jpost, name))[:n],
                                      err_msg=name)
    for ttree, jtree in ((tpost.det, jpost.det), (tbs, jbs)):
        tl, jl = dict(_leaves(ttree)), dict(_leaves(_np_tree(jtree)))
        assert tl.keys() == jl.keys()
        for k, v in tl.items():
            np.testing.assert_array_equal(v.numpy(), jl[k], err_msg=str(k))


def _twin_dict(num_classes=7, seed=0):
    torch.manual_seed(seed)
    twin = TorchMultiModal(num_classes=num_classes, width=TINY.width,
                           stage_sizes=tuple(TINY.stage_sizes))
    return twin, bayesianize_state_dict(twin, delta=0.05)[0]


# -- key mapping and inventory ------------------------------------------------------

EDGE_KEYS = (
    "module.image_model_feat.conv1.mu_kernel",
    "image_model_feat.model.layer1.0.conv2.rho_kernel",
    "bathy_model_feat.layer2.0.downsample.0.mu_kernel",
    "bathy_model_feat.layer2.0.downsample.1.weight",
    "sss_model_feat.layer3.0.downsample.1.num_batches_tracked",
    "fc2.prior_weight_mu", "fc2.prior_bias_sigma", "fc2.eps_weight",
    "attention_sss.key_projection.mu_bias", "bn1.running_var",
    "conv1.weight", "layer4.0.bn3.bias", "fc.weight", "fc.bias",
    "model.fc.rho_bias", "layer1", "weight",
)


@pytest.mark.parametrize("source", ["inventory", "edges"])
def test_key_mapping_equals_jax(source):
    """``torch_key_to_flax`` equals the JAX package's on all 1,740 keys of
    the shipped inventory (published form, and after the load-time
    ``.model.`` remap) and on edge keys."""
    if source == "inventory":
        keys = list(hf_manifest.load_manifest())
        assert len(keys) == 1740
        keys += [k.replace("_model_feat.model.", "_model_feat.")
                 for k in keys]
    else:
        keys = list(EDGE_KEYS)
    for k in keys:
        assert torch_key_to_flax(k) == jimport.torch_key_to_flax(k), k


@pytest.mark.parametrize("published", [True, False],
                         ids=["published", "unpublished"])
def test_inventory_equals_jax(jax_bundles, published):
    """The port's inventory of a tiny() bundle equals the JAX package's,
    key for key, role and shape, in both forms and with and without
    buffers."""
    jb = jax_bundles[7]
    pb = _port(jb, 7)
    for buffers in (None, True, False):
        got = hf_manifest.expected_checkpoint_keys(
            pb, published=published, include_buffers=buffers)
        want = jmanifest.expected_checkpoint_keys(
            jb, published=published, include_buffers=buffers)
        assert got == want


def test_shipped_inventory_equals_jax_and_regenerates():
    """The port ships its own expected_hf_keys.json, byte-equal to the JAX
    package's; regenerating it from the port's own full-width geometry
    (parameter shapes on the meta device, no weights drawn) gives it
    back."""
    assert hf_manifest.MANIFEST_PATH != jmanifest.MANIFEST_PATH
    assert filecmp.cmp(hf_manifest.MANIFEST_PATH, jmanifest.MANIFEST_PATH,
                       shallow=False)
    with open(jmanifest.MANIFEST_PATH) as f:
        assert hf_manifest.build_flagship_manifest() == json.load(f)


def test_load_torch_state_dict_equals_jax(tmp_path):
    """The ``module.`` strip and the ``*_model_feat.model.`` remap."""
    sd = {"module.image_model_feat.model.conv1.mu_kernel":
          torch.randn(8, 3, 7, 7),
          "module.fc2.mu_bias": torch.randn(7),
          "module.sss_model_feat.model.bn1.num_batches_tracked":
          torch.tensor(3)}
    path = str(tmp_path / "w.bin")
    torch.save(sd, path)
    got, want = load_torch_state_dict(path), jimport.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(
        ["image_model_feat.conv1.mu_kernel", "fc2.mu_bias",
         "sss_model_feat.bn1.num_batches_tracked"])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# -- import_posterior -----------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [7, 4], ids=["same_head", "head_swap"])
def test_import_twin_equals_jax(jax_bundles, num_classes):
    """A bayesianized 7-class twin's dict imported into a ``num_classes``
    bundle: bit-equal mu, rho, det and batch_stats, an equal stats dict.
    Under the 7 -> 4 head swap fc2's four mu / rho keys are dropped, fc2
    keeps the bundle's init, and the audit, whose inventory leaves fc2
    out, reports those four keys as unexpected (in both packages)."""
    _, sd = _twin_dict()
    jb = jax_bundles[num_classes]
    pb = _port(jb, num_classes)
    jpost, jbs, jstats = jimport.import_posterior(jb, sd,
                                                  num_classes=num_classes)
    tpost, tbs, tstats = import_posterior(pb, sd, num_classes=num_classes)
    _assert_bit_equal(tpost, tbs, jpost, jbs)
    assert tstats == jstats
    fc2 = sorted(k for k in sd if k.startswith("fc2."))
    assert tstats["missing"] == []
    assert tstats["unexpected"] == ([] if num_classes == 7 else fc2)
    assert tstats["dropped"] == len(fc2) - 4 * (num_classes == 7) == (
        0 if num_classes == 7 else 4)
    assert tpost.mu.device.type == "cpu"
    if num_classes == 4:
        e = next(e for e in pb.meta.entries if e.path == ("fc2", "kernel"))
        sl = slice(e.offset, e.offset + e.size)
        assert torch.equal(tpost.mu[sl], pb.post.mu[sl])


def test_moped_from_deterministic_dict_equals_jax(jax_bundles):
    """A deterministic (plain weight / bias) dict: mu takes the weights, rho
    is re-derived as log(expm1(max(0.1 |mu|, 1e-12))), exactly as the JAX
    package computes it; BN affine and statistics load directly."""
    twin, _ = _twin_dict(seed=3)
    sd = {k: v.numpy() for k, v in twin.state_dict().items()}
    jb = jax_bundles[7]
    pb = _port(jb, 7)
    jpost, jbs, jstats = jimport.import_posterior(jb, sd)
    tpost, tbs, tstats = import_posterior(pb, sd)
    _assert_bit_equal(tpost, tbs, jpost, jbs)
    assert tstats == jstats and tstats["dropped"] == 0
    e = next(e for e in pb.meta.entries
             if e.path == ("image_model_feat", "conv1", "kernel"))
    mu = tpost.mu[e.offset:e.offset + e.size].numpy()
    np.testing.assert_array_equal(
        mu, np.transpose(sd["image_model_feat.conv1.weight"],
                         (2, 3, 1, 0)).ravel())
    sigma = np.maximum(np.float32(0.1) * np.abs(mu), 1e-12)
    np.testing.assert_array_equal(tpost.rho[e.offset:e.offset + e.size],
                                  np.log(np.expm1(sigma)))


# -- export and files written by either package ----------------------------------------

def _perturbed(jb, num_classes):
    """A JAX bundle with a non-trivial posterior, and its port twin."""
    P = jb.post.mu.shape[0]
    jb.post = jb.post.replace(
        mu=jb.post.mu + 0.01 * (jnp.arange(P, dtype=jnp.float32) % 7),
        rho=jb.post.rho - 0.5)
    return jb, _port(jb, num_classes)


def test_export_equals_jax_and_files_cross_import(tmp_path):
    """``export_posterior`` gives the JAX package's keys and values; a file
    written by either package imports in the other with mu, rho, det and
    batch_stats equal to the source and equal stats; the published form
    (``module.``, ``.model.``, zero-filled buffers) imports in both with
    every buffer ignored."""
    src_j, src_p = _perturbed(jmake(5, JSpec(), jax.random.PRNGKey(3),
                                    JTINY), 5)
    got, want = export_posterior(src_p), jexport.export_posterior(src_j)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    dst_j = jmake(5, JSpec(), jax.random.PRNGKey(9), JTINY)
    dst_p = _port(dst_j, 5)
    files = {"jax": str(tmp_path / "jax.pth"), "port": str(tmp_path / "port.pth"),
             "published": str(tmp_path / "pub.bin")}
    jexport.save_torch_checkpoint(src_j, files["jax"])
    save_torch_checkpoint(src_p, files["port"])
    save_torch_checkpoint(src_p, files["published"], published=True)
    raw = torch.load(files["published"], weights_only=True)
    assert all(k.startswith("module.") for k in raw)
    assert "module.image_model_feat.model.conv1.eps_kernel" in raw
    inventory = hf_manifest.expected_checkpoint_keys(src_p, published=True)
    assert {k[len("module."):] for k in raw} == set(inventory)
    n_ignored = sum(v["role"] == "ignored" for v in inventory.values())
    for name, path in files.items():
        jpost, jbs, jstats = jimport.import_posterior(
            dst_j, jimport.load_torch_state_dict(path))
        tpost, tbs, tstats = import_posterior(dst_p, load_torch_state_dict(path))
        _assert_bit_equal(tpost, tbs, jpost, jbs)
        _assert_bit_equal(tpost, tbs, src_j.post, src_j.batch_stats,
                          src_p.meta.n_real)
        assert tstats == jstats, name
        assert tstats["dropped"] == 0 and tstats["missing"] == []
        assert tstats["unexpected"] == []
        if name == "published":
            assert tstats["ignored"] == n_ignored
            assert tstats["loaded"] == len(inventory) - n_ignored


def test_load_and_prepare_imports_in_place(tmp_path):
    """``load_and_prepare_multimodal_model`` sets the bundle's posterior and
    statistics to the file's and returns the import's stats."""
    src_j, src_p = _perturbed(jmake(7, JSpec(), jax.random.PRNGKey(5),
                                    JTINY), 7)
    path = str(tmp_path / "w.pth")
    save_torch_checkpoint(src_p, path)
    dst = _port(jmake(7, JSpec(), jax.random.PRNGKey(6), JTINY), 7)
    out, stats = load_and_prepare_multimodal_model(dst, path, num_classes=7)
    assert out is dst and stats["dropped"] == 0
    _assert_bit_equal(dst.post, dst.batch_stats, src_j.post,
                      src_j.batch_stats, src_p.meta.n_real)


# -- the hub ---------------------------------------------------------------------------

def test_hub_local_missing_and_offline(tmp_path, monkeypatch, caplog):
    """An explicit path is authoritative: returned if it exists, else
    FileNotFoundError; without one, offline (HF_HUB_OFFLINE=1) gives None
    with a warning and opens no socket."""
    def no_network(*a, **k):
        raise AssertionError(f"socket.create_connection{a} called offline")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    path = tmp_path / "pytorch_model.bin"
    path.write_bytes(b"")
    assert hub.fetch_pretrained_weights(local_path=str(path)) == str(path)
    with pytest.raises(FileNotFoundError, match="nope.bin"):
        hub.fetch_pretrained_weights(local_path=str(tmp_path / "nope.bin"))
    with caplog.at_level("WARNING"):
        assert hub.fetch_pretrained_weights() is None
    assert "Pass a local weights path" in caplog.text
    for value, offline in (("1", True), ("true", True), ("0", False),
                           ("no", False), ("", False)):
        monkeypatch.setenv("HF_HUB_OFFLINE", value)
        assert hub._env_offline() is offline
        assert jhub._env_offline() is offline


def test_export_for_hub_layout(tmp_path):
    """``export_for_hub`` writes the layout the reference downloads,
    ``multimodal-bnn/pytorch_model.bin``, and the file imports in both
    packages."""
    src_j, src_p = _perturbed(jmake(7, JSpec(), jax.random.PRNGKey(2),
                                    JTINY), 7)
    path = hub.export_for_hub(src_p, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "multimodal-bnn",
                                "pytorch_model.bin")
    assert hub.fetch_pretrained_weights(local_path=path) == path
    jpost, jbs, _ = jimport.import_posterior(
        jmake(7, JSpec(), jax.random.PRNGKey(8), JTINY),
        jimport.load_torch_state_dict(path))
    _assert_bit_equal(src_p.post, src_p.batch_stats, jpost, jbs,
                      src_p.meta.n_real)


# -- define_models(pretrained_paths) and load_models ------------------------------------

@pytest.fixture(scope="module")
def torchvision_file(tmp_path_factory):
    """A tiny torchvision-named ResNet trunk dict with a 1000-class fc."""
    torch.manual_seed(1)
    trunk = TorchResNetTrunk(3, width=TINY.width,
                             stage_sizes=tuple(TINY.stage_sizes))
    sd = dict(trunk.state_dict())
    sd["fc.weight"] = torch.randn(1000, trunk.feature_size)
    sd["fc.bias"] = torch.randn(1000)
    path = str(tmp_path_factory.mktemp("tv") / "resnet50_imagenet.pth")
    torch.save(sd, path)
    return path, {k: v.numpy() for k, v in sd.items()}


def test_define_models_pretrained_equals_jax(torchvision_file):
    """``pretrained_paths`` for all three trunks: every loaded entry of the
    four Bayesian bundles (mu and MOPED rho) and the BN statistics equal
    the JAX package's bit for bit; conv1 mu is the dict's, sigma = 0.1 |w|;
    the 1-channel sss conv1 keeps its random init; the feature trunks hold
    the dict's weights in the forward's layout."""
    path, sd = torchvision_file
    paths = {"image": path, "channels": path, "sss": path}
    jm = jdefine(7, JSpec(), jax.random.PRNGKey(0), JTINY,
                 pretrained_paths=paths)
    tm = define_models(7, BNNPriorSpec(), torch.Generator().manual_seed(0),
                       TINY, pretrained_paths=paths, device="cpu")
    conv1 = np.transpose(sd["conv1.weight"], (2, 3, 1, 0))
    prefixes = {"image_model": ("model",), "bathy_model": ("model",),
                "sss_model": ("model",), "multimodal_model": TRUNKS}
    for name, pres in prefixes.items():
        tb, jb = tm[name], jm[name]
        jmu, jrho = np.asarray(jb.post.mu), np.asarray(jb.post.rho)
        n_loaded = 0
        for e in tb.meta.entries:
            # the unimodal fc head is not the dict's 1000-class fc: random
            if e.path[0] not in pres or e.path[-2] == "fc":
                continue
            sl = slice(e.offset, e.offset + e.size)
            stem = e.path[1:] == ("conv1", "kernel")
            if stem and "sss" in name + e.path[0]:
                # channel mismatch: random init kept in both
                got = tb.post.mu[sl].numpy().reshape(e.shape)
                assert got.shape[2] == 1
                assert not np.allclose(got, conv1[:, :, :1, :])
                continue
            np.testing.assert_array_equal(tb.post.mu[sl].numpy(), jmu[sl])
            np.testing.assert_array_equal(tb.post.rho[sl].numpy(), jrho[sl])
            n_loaded += 1
            if stem:
                np.testing.assert_array_equal(
                    tb.post.mu[sl].numpy().reshape(e.shape), conv1)
                sigma = torch.nn.functional.softplus(tb.post.rho[sl])
                np.testing.assert_allclose(
                    sigma.numpy(), 0.1 * np.abs(conv1.ravel()), rtol=1e-5)
        assert n_loaded > 10, name
        pre = pres[0]
        np.testing.assert_array_equal(
            tb.batch_stats[pre]["bn1"]["mean"].numpy(),
            sd["bn1.running_mean"])
    for name in ("image_model_feat", "bathy_model_feat"):
        tv = tm[name]["variables"]
        np.testing.assert_array_equal(tv["params"]["conv1"]["kernel"].numpy(),
                                      sd["conv1.weight"])
        jv = _np_tree(jm[name]["variables"])
        np.testing.assert_array_equal(
            tv["params"]["layer1_0"]["conv2"]["kernel"].numpy(),
            np.transpose(jv["params"]["layer1_0"]["conv2"]["kernel"],
                         (3, 2, 0, 1)))
        assert tv["params"]["conv1"]["kernel"].is_contiguous()
        np.testing.assert_array_equal(
            tv["batch_stats"]["bn1"]["var"].numpy(),
            jv["batch_stats"]["bn1"]["var"])


def test_load_models_file_branch_equals_jax(torchvision_file, tmp_path,
                                            caplog):
    """``load_models`` imports a torch file into its trunk (as the JAX
    package does); a directory (an orbax checkpoint of the JAX package) is
    a logged failure that keeps the random init, as is a missing path."""
    path, sd = torchvision_file
    (img, ch, sss) = load_models({"image": path}, arch=TINY, device="cpu")
    (jimg, _, _) = jload_models({"image": path}, arch=JTINY)
    np.testing.assert_array_equal(img["variables"]["params"]["conv1"]
                                  ["kernel"].numpy(), sd["conv1.weight"])
    jv = _np_tree(jimg["variables"])
    tv = img["variables"]
    for k, v in _leaves(jv["batch_stats"]):
        got = tv["batch_stats"]
        for p in k:
            got = got[p]
        np.testing.assert_array_equal(got.numpy(), v, err_msg=str(k))
    random = load_models({}, arch=TINY, device="cpu")
    with caplog.at_level("ERROR"):
        kept = load_models({"sss": str(tmp_path)}, arch=TINY, device="cpu")
    assert "Failed to load sss model" in caplog.text
    assert "orbax" in caplog.text
    assert torch.equal(kept[2]["variables"]["params"]["conv1"]["kernel"],
                       random[2]["variables"]["params"]["conv1"]["kernel"])
