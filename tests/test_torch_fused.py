"""The grouped-conv trunks (``models/fused.py``) against the JAX package's
and against the port's unfused module.

Weights are carried from a JAX bundle (interop/from_jax.py); inputs are
made with numpy. f32 at the tiny() geometry (the full ResNet topology, one
block per stage, width 8) and 64 px, where train-mode BN over 4 rows is
well conditioned down to layer4; comparisons at 2e-5, as the JAX
package's own ``tests/test_models.py::test_fused_trunks_match_module``,
except the trunk features against JAX: XLA:CPU's convolutions and the
port's round differently, and the port's UNFUSED trunks differ from JAX's
by the same 6.8e-5 on features of magnitude ~1.3 here (the fused and
unfused port trunks agree to 7e-6), so that comparison is held at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.engine.mc as torch_mc
import multimodal_auv_tpu.engine.mc as jax_mc
from multimodal_auv_torch.engine.mc import mc_logits
from multimodal_auv_torch.engine.predict import (
    make_packed_predict_step,
    make_predict_step,
)
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.fused import (
    FusedMultiModal,
    fused_module_for,
    fused_trunks_features,
    grouped_layer_count,
)
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.engine.predict import (
    make_packed_predict_step as jmake_packed_predict_step,
)
from multimodal_auv_tpu.models import fused as jfused
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake

SIZE = 64
TOL = 2e-5
FEATURE_TOL = 1e-4  # across frameworks, see the module docstring
MASKS = {"nomask": None, "ragged": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use (and the spawned ranks')."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jb, arch):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    jax.tree_util.tree_map(np.asarray, jb.post.det),
                    jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                    [(e.path, e.shape, e.offset, e.size)
                     for e in jb.meta.entries],
                    num_classes=7, arch=arch, device="cpu")


@pytest.fixture(scope="module")
def bundles():
    jb = jmake(7, JSpec(), jax.random.PRNGKey(3), JArch.tiny(image_size=SIZE))
    return jb, _carry(jb, ArchConfig.tiny(image_size=SIZE))


def _inputs(seed=5, n=4, size=SIZE):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(n, size, size, c)).astype(np.float32)
            for c in (3, 3, 1)]


def _jax_params(jb):
    return {"params": jb.meta.unpack(jb.post.mu, jb.post.det),
            "batch_stats": jb.batch_stats}


def _port_params(pb):
    return pb.meta.unpack(pb.post.mu, pb.post.det)


def _mask(name, torch_side):
    m = MASKS[name]
    if m is None:
        return None
    return torch.from_numpy(m) if torch_side else jnp.asarray(m)


@pytest.mark.parametrize("mask", list(MASKS))
def test_fused_trunks_features_equal_jax(bundles, mask):
    """The three trunks' features of the grouped-conv program, port
    against JAX, each (4, feature_size), f32 1e-4 (``FEATURE_TOL``)."""
    jb, pb = bundles
    xs = _inputs()
    want = jfused.fused_trunks_features(
        _jax_params(jb)["params"], *[jnp.asarray(x) for x in xs],
        stage_sizes=(1, 1, 1, 1), dtype=jnp.float32,
        batch_mask=_mask(mask, False))
    got = fused_trunks_features(
        _port_params(pb), *[torch.from_numpy(x) for x in xs],
        stage_sizes=(1, 1, 1, 1), dtype=torch.float32,
        batch_mask=_mask(mask, True))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (4, 8 * 8 * 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=FEATURE_TOL, atol=FEATURE_TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_fused_module_equals_jax(bundles, mask):
    """``FusedMultiModal`` against JAX's ``fused_module_for(...).apply``:
    logits f32 2e-5; with ``mutable`` the statistics come back
    unchanged."""
    jb, pb = bundles
    xs = _inputs()
    jmod = jfused.fused_module_for(jb.module)
    want, _ = jmod.apply(_jax_params(jb), *[jnp.asarray(x) for x in xs],
                         train=True, batch_mask=_mask(mask, False),
                         mutable=["batch_stats"])
    fused = fused_module_for(pb.module)
    assert isinstance(fused, FusedMultiModal)
    assert fused.dtype == torch.float32 and fused.stage_sizes == (1, 1, 1, 1)
    got, stats = fused(_port_params(pb), pb.batch_stats,
                       *[torch.from_numpy(x) for x in xs], train=True,
                       batch_mask=_mask(mask, True), mutable=True)
    assert stats is pb.batch_stats
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_fused_module_equals_unfused(bundles, mask):
    """The grouped trunks against the port's own ``MultiModalModel`` on
    the same tree (f32 2e-5), and through ``mc_logits`` with sampled
    weights (two draws, same generator seed)."""
    _, pb = bundles
    xs = [torch.from_numpy(x) for x in _inputs(seed=8)]
    m = _mask(mask, True)
    fused = fused_module_for(pb.module)
    want = pb.module(_port_params(pb), pb.batch_stats, *xs, train=True,
                     batch_mask=m)
    got = fused(_port_params(pb), pb.batch_stats, *xs, train=True,
                batch_mask=m)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)

    def run(module):
        return mc_logits(module, pb.meta, pb.post, pb.batch_stats, xs,
                         torch.Generator().manual_seed(9), 2, train=True,
                         remat=False, batch_mask=m, split_sampling=True)

    np.testing.assert_allclose(run(fused).numpy(), run(pb.module).numpy(),
                               rtol=TOL, atol=TOL)


def test_fused_packed_predict_step_equals_jax(monkeypatch):
    """``make_packed_predict_step(fused_trunks=True)`` against JAX's, micro()
    at 32 px, 4 draws in one chunk, a ragged mask: both packages'
    split samplers return the same numpy draws (the TPU's noise cannot be
    reproduced). Predicted classes equal, uncertainties and mean
    probabilities to 2e-5; the port's fused and unfused steps agree to
    2e-5 too."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    pb = _carry(jb, ArchConfig.micro())
    mu = np.asarray(jb.post.mu)
    sigma = np.asarray(jax.nn.softplus(jb.post.rho))
    rng = np.random.default_rng(2)
    draws = [(mu + sigma * rng.standard_normal(mu.shape)).astype(np.float32)
             for _ in range(4)]

    def jax_sampler(mu, sigma, key, num_draws, *, impl, out_dtype,
                    fast_math):
        return [jnp.asarray(d).astype(out_dtype) for d in draws]

    def torch_sampler(mu, sigma, seed, num_draws, *, out_dtype, fast_math):
        assert num_draws == 4
        return [torch.from_numpy(d).to(out_dtype) for d in draws]

    monkeypatch.setattr(jax_mc, "gaussian_shift_scale_split", jax_sampler)
    monkeypatch.setattr(torch_mc, "gaussian_shift_scale_split", torch_sampler)
    rng = np.random.default_rng(4)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jstep = jmake_packed_predict_step(jb, 4, mc_chunk=4,
                                      sample_dtype=jnp.float32,
                                      fused_trunks=True)
    want = jstep(jb.post, jb.batch_stats, tuple(jnp.asarray(a) for a in u8),
                 jax.random.PRNGKey(1), jnp.asarray(mask))
    got = {}
    for fused in (True, False):
        step = make_packed_predict_step(pb, 4, mc_chunk=4,
                                        sample_dtype=torch.float32,
                                        fused_trunks=fused)
        got[fused] = step(pb.post, pb.batch_stats,
                          [torch.from_numpy(a) for a in u8],
                          torch.Generator().manual_seed(1),
                          torch.from_numpy(mask).bool())
    out = got[True]
    assert out["predicted"].tolist() == np.asarray(want["predicted"]).tolist()
    for k in ("predictive_uncertainty", "aleatoric_uncertainty",
              "mean_prob"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), got[False][k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_fused_refuses_eval_bn(bundles):
    """The grouped trunks compute train-mode BN only: the module raises on
    ``train=False`` (as JAX's ``FusedMultiModal.apply``), and both predict
    steps refuse ``bn_mode="eval"`` with ``fused_trunks`` at build time
    rather than run unfused."""
    _, pb = bundles
    xs = [torch.from_numpy(x) for x in _inputs()]
    with pytest.raises(NotImplementedError, match="train=True"):
        fused_module_for(pb.module)(_port_params(pb), pb.batch_stats, *xs,
                                    train=False)
    for make in (make_predict_step, make_packed_predict_step):
        with pytest.raises(ValueError, match="fused_trunks"):
            make(pb, 2, fused_trunks=True, bn_mode="eval")
        make(pb, 2, fused_trunks=True, bn_mode="train")


def test_grouped_layer_count():
    """53 grouped conv layers (and concatenation copies) per draw at
    ResNet-50's (3, 4, 6, 3); 17 at tiny()."""
    assert grouped_layer_count((3, 4, 6, 3)) == 53
    assert grouped_layer_count((1, 1, 1, 1)) == 17
