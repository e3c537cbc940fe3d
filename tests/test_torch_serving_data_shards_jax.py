"""Data-sharded serving artifacts against the JAX package's own
(multimodal_auv_torch/serving.py, ``data_shards``, alone and with
``mc_shards``, and the DVP program with ``data_shards``; the port against
itself: tests/test_torch_serving_data_shards.py,
tests/test_torch_serving_data_shards_composed.py and
tests/test_torch_serving_dvp_data_shards.py).

The posterior mean carried from JAX (rho = -30, so every draw is the
posterior mean in both packages, whatever their noise): the port's
data_shards=2, (2 data x 2 mc) and data_shards=2 DVP artifacts against
the JAX package's own, which run on tests/conftest.py's 8 virtual CPU
devices, to tests/test_torch_serving.py's tolerances.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.serving import (
    export_predict_artifact,
    load_predict_artifact,
)
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from multimodal_auv_tpu.serving import export_predict_artifact as jax_export
from multimodal_auv_tpu.serving import load_predict_artifact as jax_load
from tests.test_torch_serving_data_shards import _batch

ARCH = ArchConfig.micro()
B, PX, MC, C = 4, 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the graphs are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def posterior_mean(tmp_path_factory):
    """The JAX micro() bundle with rho = -30, its JAX artifacts at
    data_shards=2, (2 data x 2 mc) and DVP at data_shards=2, and the
    port's of the same posterior (carried by ``from_jax``), loaded on CPU
    devices; keyed (mode, data, mc)."""
    jb = jmake(C, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    jb.post = jb.post.replace(rho=jnp.full_like(jb.post.rho, -30.0))
    tb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  jax.tree_util.tree_map(np.asarray, jb.post.det),
                  jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=C, arch=ARCH, device="cpu")
    out = {}
    for mode, n, m in (("mc", 2, 1), ("mc", 2, 2), ("dvp", 2, 1)):
        jd = str(tmp_path_factory.mktemp(f"jax_{mode}_d{n}m{m}"))
        jax_export(jb, jd, batch_size=B, num_mc_samples=MC, image_size=PX,
                   mode=mode, data_shards=n, mc_shards=m)
        d = str(tmp_path_factory.mktemp(f"port_{mode}_d{n}m{m}"))
        export_predict_artifact(
            tb, d, batch_size=B, num_mc_samples=MC, image_size=PX,
            mode=mode, data_shards=n, mc_shards=m,
            mc_chunk=1 if (mode, m) == ("mc", 1) else None)
        out[(mode, n, m)] = (jd, d, load_predict_artifact(
            d, devices=["cpu"] * (n * m)))
    yield out
    for _, _, art in out.values():
        art.close()


@pytest.mark.parametrize("shards", [("mc", 2, 1), ("mc", 2, 2),
                                    ("dvp", 2, 1)],
                         ids=["d2", "d2m2", "dvp_d2"])
def test_equals_jax_artifact_at_posterior_mean(posterior_mean, shards):
    """The port's sharded artifact against the JAX package's with the same
    mode and shards on the same batch: predicted classes equal; mean_prob
    and the aleatoric entropy to 1e-5 absolute; the predictive variance
    (~0 in both) to 1e-6; meta.json has the JAX artifact's keys and
    ``torch_version``, with the same mode and shards."""
    jd, d, art = posterior_mean[shards]
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
    ours = json.load(open(os.path.join(d, "meta.json")))
    theirs = json.load(open(os.path.join(jd, "meta.json")))
    assert set(ours) == set(theirs) | {"torch_version"}
    for k in ("mode", "data_shards", "mc_shards", "batch_size",
              "num_mc_samples"):
        assert ours[k] == theirs[k], k
