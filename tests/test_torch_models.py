"""The port's packed posterior and models against the JAX package's, at the
tiny() geometry (full ResNet topology, 1 block per stage, width 8).

Weights go across as numpy through interop/from_jax.py; the same flat
weight vector then goes through both forwards in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.bayes.packing import bayesianize
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _entries(meta):
    return [(e.path, e.shape, e.offset, e.size) for e in meta.entries]


@pytest.fixture(scope="module")
def bundles():
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.tiny())
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                  _entries(jb.meta), num_classes=7, arch=ArchConfig.tiny(),
                  device="cpu")
    return jb, pb


def test_from_jax_layout_equals_jax(bundles):
    jb, pb = bundles
    assert _entries(pb.meta) == _entries(jb.meta)
    assert (pb.meta.n_real, pb.meta.n_padded) == (jb.meta.n_real,
                                                 jb.meta.n_padded)
    # a different head is a different layout, and is refused
    with pytest.raises(ValueError, match="layouts differ"):
        from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                 _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                 _entries(jb.meta), num_classes=5, arch=ArchConfig.tiny(),
                 device="cpu")


def test_unpack_equals_jax(bundles):
    """Every leaf of the port's unpack (one split + views; 4-D kernels
    permuted HWIO -> OIHW) equals JAX's static slice, exactly."""
    jb, pb = bundles
    w = np.random.default_rng(0).standard_normal(
        pb.meta.n_padded).astype(np.float32)
    jp = jb.meta.unpack(jnp.asarray(w), jb.post.det)
    tp = pb.meta.unpack(torch.from_numpy(w), pb.post.det)
    for e in jb.meta.entries:
        want, got = jp, tp
        for k in e.path:
            want, got = want[k], got[k]
        want = np.asarray(want)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bayesianize_moped_equals_jax(bundles):
    """MOPED on the same deterministic tree gives JAX's mu exactly and its
    rho = log(expm1(max(0.1|w|, 1e-12))) to f32 rounding (rtol 1e-6), with
    the pad at (prior_mu, softplus_inv(prior_sigma))."""
    jb, _ = bundles
    params = _torch_tree(_np_tree(jb.meta.unpack(jb.post.mu, jb.post.det)))
    post, meta = bayesianize(params, BNNPriorSpec())
    assert _entries(meta) == _entries(jb.meta)
    np.testing.assert_array_equal(post.mu.numpy(), np.asarray(jb.post.mu))
    np.testing.assert_allclose(post.rho.numpy(), np.asarray(jb.post.rho),
                               rtol=1e-6)
    np.testing.assert_allclose(post.rho.numpy()[meta.n_real:],
                               np.log(np.expm1(1.0)), rtol=1e-6)


@pytest.mark.parametrize("mode", ["train", "train_masked", "eval"])
def test_forward_equals_flax(bundles, mode):
    """Logits of the same flat w through flax and the port, f32, at rtol
    1e-4 / atol 1e-5 (conv and reduction order differ between XLA:CPU and
    PyTorch). Batch 3; the masked case uses mask [1, 1, 0], compares the
    two real rows, and also checks that they equal an unpadded batch of two
    (the mask's purpose). Inputs are 64 px so that layer4 keeps 2x2
    positions: at 32 px a two-row batch statistic there is over two values
    per channel, whose E[x^2] - E[x]^2 cancels and magnifies f32 rounding
    to ~2e-4 in both frameworks alike. The pad row is not compared: it is
    normalised by statistics it took no part in and never reaches the CSV.
    """
    jb, pb = bundles
    rng = np.random.default_rng(1)
    w = (np.asarray(jb.post.mu)
         + 0.05 * rng.standard_normal(pb.meta.n_padded)).astype(np.float32)
    x = [rng.standard_normal((3, 64, 64, c)).astype(np.float32)
         for c in (3, 3, 1)]
    train = mode != "eval"
    mask = np.array([1, 1, 0], bool) if mode == "train_masked" else None
    params = jb.meta.unpack(jnp.asarray(w), jb.post.det)
    jx = [jnp.asarray(a) for a in x]
    if train:
        jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
        want, _ = jb.module.apply(
            {"params": params, "batch_stats": jb.batch_stats}, *jx,
            train=True, batch_mask=jmask, mutable=["batch_stats"])
        stats = None
    else:
        # running statistics that differ per channel
        stats = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            if a.ndim else a, _np_tree(jb.batch_stats))
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, stats)
        want = jb.module.apply({"params": params, "batch_stats": stats},
                               *jx, train=False)
    with torch.no_grad():
        got = pb.apply_with_weights(
            torch.from_numpy(w), *[torch.from_numpy(a) for a in x],
            train=train,
            batch_mask=None if mask is None else torch.from_numpy(mask),
            batch_stats=None if stats is None else _torch_tree(stats))
    want, got = np.asarray(want), got.numpy()
    rows = slice(0, 2) if mask is not None else slice(None)
    if mask is not None:
        with torch.no_grad():
            two = pb.apply_with_weights(
                torch.from_numpy(w), *[torch.from_numpy(a[:2]) for a in x])
        np.testing.assert_allclose(got[rows], two.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert np.abs(want[rows]).max() > 1e-2  # not a vacuous comparison
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-4, atol=1e-5)
