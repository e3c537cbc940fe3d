"""The port's main path as a whole against the JAX package's: packed MC
inference to the reference-schema CSV, at the micro() geometry, 32 px.

The TPU's noise cannot be reproduced, so both samplers are replaced, in
this test only, by one returning the same numpy draws; everything else —
sigma hoist, bf16 sample cast, normalise, masked train-mode BN over the
padded ragged tail, forward, uncertainty, CSV — is each package's own.
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.engine.mc as torch_mc
import multimodal_auv_tpu.engine.mc as jax_mc
from multimodal_auv_torch.engine.predict import (
    CSV_HEADER,
    multimodal_predict_and_save_packed,
)
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.pipelines.inference import run_auv_inference
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.engine.predict import (
    multimodal_predict_and_save_packed as jax_predict_packed,
)
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from tests.fixtures.make_tree import make_inference_tree


def _write_packed(out_dir, n, size, seed):
    """A packed set in data/packing.py's format, made with numpy."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for key, c in (("main", 3), ("bathy", 3), ("sss", 1)):
        np.save(os.path.join(out_dir, f"{key}.npy"),
                rng.integers(0, 256, (n, size, size, c), dtype=np.uint8))
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump([f"frame_{i:04d}.jpg" for i in range(n)], f)
    with open(os.path.join(out_dir, "pack_meta.json"), "w") as f:
        json.dump({"size": size, "fingerprint": "test"}, f)
    return out_dir


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_packed_predict_csv_equals_jax(tmp_path, monkeypatch):
    """5 samples, batch 2 (ragged tail of 1, padded and masked), 4 MC draws
    in one chunk of 4, so the JAX step calls its sampler once per trace and
    the port once per batch. Names and predicted classes must be equal;
    the uncertainties agree to atol 1e-5 (f32 forwards, reductions in
    another order)."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  jax.tree_util.tree_map(np.asarray, jb.post.det),
                  jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=7, arch=ArchConfig.micro(), device="cpu")
    mu = np.asarray(jb.post.mu)
    sigma = np.asarray(jax.nn.softplus(jb.post.rho))
    rng = np.random.default_rng(2)
    draws = [(mu + sigma * rng.standard_normal(mu.shape)).astype(np.float32)
             for _ in range(4)]
    calls = {"jax": 0, "torch": 0}

    def jax_sampler(mu, sigma, key, num_draws, *, impl, out_dtype,
                    fast_math):
        assert num_draws == 4 and out_dtype == jnp.bfloat16 and fast_math
        calls["jax"] += 1
        return [jnp.asarray(d).astype(out_dtype) for d in draws]

    def torch_sampler(mu, sigma, seed, num_draws, *, out_dtype, fast_math):
        assert num_draws == 4 and out_dtype == torch.bfloat16 and fast_math
        calls["torch"] += 1
        return [torch.from_numpy(d).to(out_dtype) for d in draws]

    monkeypatch.setattr(jax_mc, "gaussian_shift_scale_split", jax_sampler)
    monkeypatch.setattr(torch_mc, "gaussian_shift_scale_split", torch_sampler)
    packed = _write_packed(str(tmp_path / "packed"), 5, 32, seed=3)
    jcsv, tcsv = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    jax_predict_packed(jb, packed, jcsv, num_mc_samples=4, batch_size=2,
                       mc_chunk=4)
    multimodal_predict_and_save_packed(pb, packed, tcsv, num_mc_samples=4,
                                       batch_size=2, mc_chunk=4,
                                       device="cpu")
    assert calls["jax"] == 1 and calls["torch"] == 3
    jhead, jrows = _read_csv(jcsv)
    thead, trows = _read_csv(tcsv)
    assert thead == jhead == CSV_HEADER
    assert len(trows) == len(jrows) == 5
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    got = np.array([[float(v) for v in r[2:]] for r in trows])
    want = np.array([[float(v) for v in r[2:]] for r in jrows])
    assert np.all(want[:, 1] > 1.0)  # a real, non-degenerate entropy
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True], ids=["folders", "packed"])
def test_run_auv_inference_cpu(tmp_path, packed):
    """The port's pipeline over a synthetic survey tree, with the real
    (plain-version) sampler: reference CSV schema, one row per folder,
    finite values, aleatoric <= ln 7."""
    root = make_inference_tree(str(tmp_path / "dives"), n_samples=5)
    out = str(tmp_path / "out.csv")
    run_auv_inference(root, batch_size=2, output_csv=out, num_mc_samples=2,
                      allow_random_init=True, arch=ArchConfig.micro(),
                      use_packed_loader=packed, device="cpu")
    head, rows = _read_csv(out)
    assert head == CSV_HEADER
    assert sorted(r[0] for r in rows) == [f"Frame_{i:04d}.jpg"
                                          for i in range(5)]
    vals = np.array([[float(v) for v in r[1:]] for r in rows])
    assert np.isfinite(vals).all()
    assert ((vals[:, 0] >= 0) & (vals[:, 0] < 7)).all()
    assert (vals[:, 2] <= np.log(7) + 1e-4).all()
    if packed:
        assert os.path.exists(os.path.join(root, ".packed_cache_32",
                                           "pack_meta.json"))


def test_mc_logits_seeds_and_unported_flags():
    """Same generator seed -> same logits, another seed -> other logits;
    the flags of paths not ported yet raise, naming their ROADMAP item."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle

    b = make_multimodal_bundle(7, BNNPriorSpec(),
                               torch.Generator().manual_seed(0),
                               ArchConfig.micro(), device="cpu")
    x = [torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, c)).astype(np.float32)) for c in (3, 3, 1)]

    def run(seed, **kw):
        kw.setdefault("split_sampling", True)
        return torch_mc.mc_logits(b.module, b.meta, b.post, b.batch_stats, x,
                                  torch.Generator().manual_seed(seed), 2,
                                  mc_chunk=2, sample_dtype=torch.bfloat16,
                                  **kw)

    a = run(0)
    assert a.shape == (2, 2, 7)
    assert torch.equal(a, run(0))
    assert not torch.equal(a, run(1))
    assert not torch.equal(a[0], a[1])
    for kw in ({"antithetic": True}, {"ws_sharding": object()},
               {"pipelined": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run(0, **kw)


def test_run_auv_inference_refusals(tmp_path):
    """No weights (offline, no path) without allow_random_init, and a
    weights path that does not exist, raise; so do the flags of paths not
    ported yet, naming their ROADMAP item."""
    with pytest.raises(RuntimeError, match="allow_random_init"):
        run_auv_inference(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="w.pt"):
        run_auv_inference(str(tmp_path), model_weights_path="w.pt",
                          arch=ArchConfig.micro(), device="cpu")
    for kw, item in (({"use_dvp": True}, "DVP"),
                     ({"mesh_spec": object()}, "parallel")):
        with pytest.raises(NotImplementedError, match=item):
            run_auv_inference(str(tmp_path), allow_random_init=True,
                              device="cpu", **kw)
