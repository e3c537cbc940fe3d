"""The DVP serving artifact and the CLI's DVP flags, on the CPU.

One batch-polymorphic DVP artifact is made for the module by
``export-serving --dvp --batch_size poly --tiny`` (random init, seed 0):
its meta records the mode and the spread, which equals the JAX package's
own ``posterior_spread`` of the same posterior, and its ``predict_batches``
equals the in-process DVP step bit for bit at the same seeds for batches
of 1, 4 and 5 rows (the loader serves the DVP program as one chunk of all
draws).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch import cli
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.moment import (
    make_dvp_predict_step,
    posterior_spread,
)
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.serving import (
    export_predict_artifact,
    fold_seed,
    load_predict_artifact,
)
from multimodal_auv_tpu.bayes.packing import PackedPosterior as JPost
from multimodal_auv_tpu.engine.moment import posterior_spread as jax_spread
from tests.fixtures.make_tree import make_inference_tree

MC, C = 4, 7
TINY = ArchConfig.tiny(image_size=64)  # the CLI's --tiny


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the graphs are tiny, and idle OpenMP threads
    would spin on the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle(arch, spread=None):
    """The CLI's random-init bundle at seed 0 (sigma = spread |mu| on the
    real region if given)."""
    pb = make_multimodal_bundle(C, BNNPriorSpec(),
                                torch.Generator().manual_seed(0), arch,
                                device="cpu")
    if spread is not None:
        n = pb.meta.n_real
        with torch.no_grad():
            pb.post.rho[:n] = torch.log(torch.expm1(torch.clamp_min(
                spread * pb.post.mu[:n].abs(), 1e-12)))
    return pb


def _check_spread(meta, pb):
    """meta.json's spread is the port's ``posterior_spread`` rounded to 6
    places, and that equals the JAX package's of the same posterior (over
    its real region) to 1e-6 relative. Returns it."""
    got = posterior_spread(pb.post, pb.meta)
    assert meta["posterior_spread"] == round(got, 6)
    n = pb.meta.n_real
    want = float(jax_spread(JPost(mu=jnp.asarray(pb.post.mu[:n].numpy()),
                                  rho=jnp.asarray(pb.post.rho[:n].numpy()),
                                  det={})))
    assert abs(got - want) <= 1e-6 * want
    return got


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(artifact dir, the CLI's exit code, the bundle it exported, the
    loaded artifact)."""
    d = str(tmp_path_factory.mktemp("dvp_artifact"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")
        rc = cli.main(["export-serving", "--output_dir", d, "--batch_size",
                       "poly", "--num_mc_samples", str(MC), "--dvp",
                       "--dvp_on_excess", "mc", "--allow_random_init",
                       "--device", "cpu", "--tiny"])
    return d, rc, _bundle(TINY), load_predict_artifact(d, device="cpu")


def _batches(sizes=(1, 4, 5), seed=0):
    """uint8 batches of the given sizes; the one of 4 has a pad row."""
    rng = np.random.default_rng(seed)
    s = TINY.image_size
    out = []
    for b in sizes:
        arrays = [rng.integers(0, 256, (b, s, s, c), dtype=np.uint8)
                  for c in (3, 3, 1)]
        mask = np.ones((b,), np.float32)
        if b == 4:
            mask[-1] = 0.0
        out.append((*arrays, mask))
    return out


def test_dvp_artifact_meta(artifact):
    """meta.json records the mode built and the spread (``_check_spread``:
    JAX's to 1e-6 relative), under the JAX artifact's keys; the loader
    serves the program as one chunk of all MC draws."""
    d, _, pb, art = artifact
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["mode"] == "dvp" == art.mode
    assert meta["batch_size"] == "poly"
    assert 0.05 < _check_spread(meta, pb) < 0.15
    assert (art.mc_chunk, art.nchunks) == (MC, 1)


def test_dvp_artifact_equals_in_process_step(artifact):
    """The batch-polymorphic artifact's ``predict_batches`` over batches of
    1, 4 (one pad row) and 5 rows equals the in-process DVP step bit for
    bit at the same seeds."""
    _, _, pb, art = artifact
    batches = _batches()
    step = make_dvp_predict_step(pb, MC, packed_inputs=True)
    outs = list(art.predict_batches(batches, key=5))
    assert len(outs) == len(batches)
    for i, (batch, out) in enumerate(zip(batches, outs)):
        ref = step(pb.post, pb.batch_stats,
                   tuple(torch.from_numpy(a) for a in batch[:3]),
                   torch.Generator().manual_seed(fold_seed(5, i)),
                   torch.from_numpy(batch[3]))
        for k in ("csv_cols", "mean_prob"):
            np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(out["predicted"],
                                      ref["predicted"].numpy())


def test_dvp_export_guardrail_falls_back_to_mc(tmp_path):
    """A spread posterior (sigma = 0.5 |mu|) with ``dvp_on_excess="mc"``
    exports the exact MC program and records mode "mc" and its spread;
    ``mc_shards`` > 1 with DVP is refused before anything is built."""
    arch = ArchConfig.micro()
    pb = _bundle(arch, spread=0.5)
    with pytest.raises(ValueError, match="mc_shards"):
        export_predict_artifact(pb, str(tmp_path / "x"), batch_size=1,
                                num_mc_samples=2, image_size=arch.image_size,
                                mode="dvp", mc_shards=2)
    d = str(tmp_path / "mc")
    export_predict_artifact(pb, d, batch_size=1, num_mc_samples=1,
                            image_size=arch.image_size, mode="dvp",
                            dvp_on_excess="mc")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["mode"] == "mc"
    assert _check_spread(meta, pb) > 0.15


@pytest.mark.parametrize("command", ["inference", "export-serving"])
def test_cli_dvp_runs_on_cpu(tmp_path, monkeypatch, artifact, command):
    """``inference --dvp`` and ``export-serving --dvp`` at ``--tiny`` on the
    CPU, random init, offline: a CSV with one row per folder; an artifact
    (the module's, made by the CLI) whose meta records mode "dvp" and the
    CLI's arguments."""
    if command == "inference":
        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        root = make_inference_tree(str(tmp_path / "dives"), n_samples=3)
        out = str(tmp_path / "o.csv")
        assert cli.main(["inference", "--data_dir", root, "--output_csv",
                         out, "--batch_size", "2", "--packed_loader",
                         "--allow_random_init", "--num_mc_samples", "2",
                         "--dvp", "--device", "cpu", "--tiny"]) == 0
        with open(out) as f:
            rows = f.read().splitlines()
        assert len(rows) == 1 + 3
    else:
        d, rc, _, _ = artifact
        assert rc == 0
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        assert meta["mode"] == "dvp" and meta["posterior_spread"] < 0.15
        assert (meta["num_mc_samples"], meta["image_size"],
                meta["num_classes"]) == (MC, TINY.image_size, C)
