"""The port's single-pass DVP (multimodal_auv_torch/engine/moment.py)
against the JAX package's engine/moment.py, at the geometry of
tests/test_moment.py: stage_sizes (1, 1), width 8, 32 px, f32.

The primitives and the moment trunk are deterministic and compared
directly. The step samples its features and head weights with kernel #1
(Philox) where JAX uses threefry keys, so the whole step is compared under
JAX's own normals: the test re-derives them from the key with the key
schedule of the JAX step and injects them into the port's draw, in this
test only. Weights go across as numpy through interop/from_jax.py.
"""
import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.engine.moment as T
import multimodal_auv_tpu.engine.moment as J
from multimodal_auv_torch.engine.predict import (
    CSV_HEADER,
    make_packed_predict_step,
    make_predict_step,
)
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.ops.sampling import split_plain
from multimodal_auv_torch.pipelines.inference import run_auv_inference
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from multimodal_auv_tpu.models.model_utils import make_unimodal_bundle as jmake_uni
from tests.fixtures.make_tree import make_inference_tree

ARCH = ArchConfig.micro()
JARCH = JArch(stage_sizes=(1, 1), width=8, image_size=32, dtype=jnp.float32)
STAGES = (1, 1)
B, S = 3, 5
PROJ = ("key_projection", "value_projection", "query_projection",
        "attention_mechanism")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jb, kind="multimodal", num_classes=7):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                    [(e.path, e.shape, e.offset, e.size)
                     for e in jb.meta.entries],
                    num_classes=num_classes, arch=ARCH, kind=kind,
                    device="cpu")


def _with_mu(jb, fn):
    """The JAX bundle with mu replaced by fn(mu) (numpy, f32)."""
    mu = fn(np.array(jb.post.mu, np.float32))
    jb.post = jb.post.replace(mu=jnp.asarray(mu.astype(np.float32)))
    return jb


def _spread_to(jb, s):
    """A copy of the JAX bundle with sigma = s |mu| on the real packed
    region, as scripts/probe_dvp_spread.py sets it."""
    n = jb.meta.n_real
    mu, rho = np.asarray(jb.post.mu), np.array(jb.post.rho)
    rho[:n] = np.log(np.expm1(np.maximum(s * np.abs(mu[:n]), 1e-12)))
    jb = copy.copy(jb)
    jb.post = jb.post.replace(rho=jnp.asarray(rho.astype(np.float32)))
    return jb


@pytest.fixture(scope="module")
def bundles():
    """A MOPED micro() multimodal bundle in JAX, its fc head's means scaled
    by 4 (so the outputs are far from uniform and the comparisons see the
    head), and the same posterior carried into the port."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JARCH)
    scale = np.ones(jb.meta.n_padded, np.float32)
    for e in jb.meta.entries:
        if e.path[0] in ("fc", "fc1", "fc2"):
            scale[e.offset:e.offset + e.size] = 4.0
    jb = _with_mu(jb, lambda mu: mu * scale)
    return jb, _carry(jb)


def _inputs(seed=0, n=B, channels=(3, 3, 1)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(n, 32, 32, c)).astype(np.float32)
            for c in channels]


def _close(got, want, tol, scale, what):
    """|got - want| <= tol * scale elementwise, where ``scale`` is the
    magnitude of the terms the result sums or subtracts (so a value that
    cancels to ~0 is held to the precision of its terms, not to itself)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.asarray(scale, np.float64)
    assert np.all(err <= tol), f"{what}: worst error / scale {err.max():.3e}"


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _oihw(a):
    return torch.from_numpy(a).permute(3, 2, 0, 1)


def _primitive_data():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    v = rng.uniform(0.01, 1.0, size=m.shape).astype(np.float32)
    return rng, m, v


def _case_relu(degenerate):
    _, m, v = _primitive_data()
    if degenerate:  # exact zeros and values under the 1e-12 cut
        v[0, :, :, :3] = 0.0
        v[1, :2] = 1e-13
    jm, jv = J.relu_moments(jnp.asarray(m), jnp.asarray(v))
    tm, tv = T.relu_moments(torch.from_numpy(m), torch.from_numpy(v))
    sd = np.sqrt(np.maximum(v, 1e-12))
    _close(tm, jm, 1e-6, np.abs(m) + sd, "relu mean")
    _close(tv, jv, 1e-6, m * m + v, "relu var")
    if degenerate:
        cut = v <= 1e-12
        np.testing.assert_array_equal(tm.numpy()[cut], np.maximum(m, 0)[cut])
        assert np.all(tv.numpy()[cut] == 0.0)


def _case_conv(stride):
    rng, m, v = _primitive_data()
    mk = (rng.normal(size=(3, 3, 6, 4)) * 0.2).astype(np.float32)
    vk = rng.uniform(1e-3, 5e-3, (3, 3, 6, 4)).astype(np.float32)
    jm, jv = J.conv_moments(jnp.asarray(m), jnp.asarray(v), jnp.asarray(mk),
                            jnp.asarray(vk), strides=(stride, stride),
                            padding=[(1, 1), (1, 1)])
    tm, tv = T.conv_moments(_nchw(m), _nchw(v), _oihw(mk), _oihw(vk), stride)
    scale = torch.nn.functional.conv2d(_nchw(np.abs(m)), _oihw(np.abs(mk)),
                                       stride=stride, padding=1)
    _close(_nhwc(tm), jm, 1e-5, _nhwc(scale), "conv mean")
    _close(_nhwc(tv), jv, 1e-5, np.asarray(jv), "conv var")


def _case_dense(bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    xv = rng.uniform(0.01, 0.1, (5, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 12)) * 0.3).astype(np.float32)
    wv = rng.uniform(1e-3, 1e-2, (16, 12)).astype(np.float32)
    extra = ((rng.normal(size=12).astype(np.float32),
              rng.uniform(1e-3, 1e-2, 12).astype(np.float32)) if bias
             else ())
    jm, jv = J.dense_moments(*[jnp.asarray(a) for a in (x, xv, w, wv)
                               + extra])
    tm, tv = T.dense_moments(*[torch.from_numpy(a) for a in (x, xv, w, wv)
                               + extra])
    scale = np.abs(x) @ np.abs(w) + (np.abs(extra[0]) if bias else 0.0)
    _close(tm, jm, 1e-5, scale, "dense mean")
    _close(tv, jv, 1e-5, np.asarray(jv), "dense var")


def _case_bn():
    rng, m, v = _primitive_data()
    sc = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bi = rng.normal(size=6).astype(np.float32)
    jm, jv = J.batchnorm_moments(jnp.asarray(m), jnp.asarray(v),
                                 jnp.asarray(sc), jnp.asarray(bi))
    tm, tv = T.batchnorm_moments(_nchw(m), _nchw(v), torch.from_numpy(sc),
                                 torch.from_numpy(bi))
    bm = m.mean(axis=(0, 1, 2))
    inv = sc / np.sqrt(m.var(axis=(0, 1, 2)) + v.mean(axis=(0, 1, 2)) + 1e-5)
    _close(_nhwc(tm), jm, 1e-6, (np.abs(m) + np.abs(bm)) * inv + np.abs(bi),
           "bn mean")
    _close(_nhwc(tv), jv, 1e-6, np.asarray(jv), "bn var")


def _case_maxpool():
    _, m, v = _primitive_data()
    jm, jv = J.maxpool_moments(jnp.asarray(m), jnp.asarray(v))
    tm, tv = T.maxpool_moments(_nchw(m), _nchw(v))
    _close(_nhwc(tm), jm, 1e-6, np.abs(np.asarray(jm)), "maxpool mean")
    _close(_nhwc(tv), jv, 1e-6, np.asarray(jv), "maxpool var")


def _case_gap():
    _, m, v = _primitive_data()
    jm, jv = J.gap_moments(jnp.asarray(m), jnp.asarray(v))
    tm, tv = T.gap_moments(_nchw(m), _nchw(v))
    _close(tm, jm, 1e-6, np.abs(m).mean(axis=(1, 2)), "gap mean")
    _close(tv, jv, 1e-6, np.asarray(jv), "gap var")


PRIMITIVES = {
    "relu": lambda: _case_relu(False),
    "relu_degenerate_v": lambda: _case_relu(True),
    "conv_stride1": lambda: _case_conv(1),
    "conv_stride2": lambda: _case_conv(2),
    "dense": lambda: _case_dense(False),
    "dense_bias": lambda: _case_dense(True),
    "batchnorm": _case_bn,
    "maxpool": _case_maxpool,
    "gap": _case_gap,
}


@pytest.mark.parametrize("case", list(PRIMITIVES))
def test_primitive_matches_jax(case):
    """Each moment primitive against the JAX package's on the same numpy
    inputs (the port in NCHW / OIHW, JAX in NHWC / HWIO). Tolerance:
    1e-6 for the elementwise ones and 1e-5 for conv and dense, relative to
    the magnitude of the terms each result combines (``_close``)."""
    PRIMITIVES[case]()


def test_moment_trunk_matches_jax(bundles):
    """``moment_resnet_features`` of each trunk against JAX's on the same
    posterior and inputs: mean and variance to 1e-4 relative (f32 moment
    passes through five convolutions, summed in other orders)."""
    jb, pb = bundles
    jmu, jvar = J._split_trees(jb.meta, jb.post)
    tmu, tvar, _ = T._split_trees(pb.meta, pb.post)
    for name, x in zip(T._TRUNKS, _inputs()):
        jm, jv = J.moment_resnet_features(jmu[name], jvar[name],
                                          jnp.asarray(x), STAGES)
        tm, tv = T.moment_resnet_features(tmu[name], tvar[name],
                                          torch.from_numpy(x), STAGES)
        assert np.all(np.asarray(jv) > 0)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                                   atol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                                   atol=0)


# ---------------------------------------------------------------------------
# the step under JAX's noise
# ---------------------------------------------------------------------------

def _fill(eps, s, layout, path, values):
    off, shape = layout.offsets[path]
    eps[s, off:off + int(np.prod(shape))] = np.asarray(values).ravel()


def _fill_features(eps, s, layout, trunk, values):
    base = layout.head + trunk * B * layout.row
    for b in range(B):
        start = base + b * layout.row
        eps[s, start:start + layout.features] = np.asarray(values)[b]


def _jax_eps_multimodal(key, layout):
    """The (S, n) normals the JAX step draws (moment.py's ``head_one``
    under ``vmap`` over ``split(key, S)``), in the port's draw layout."""
    n = layout.head + 3 * B * layout.row
    eps = np.zeros((S, n), np.float32)
    for s, k in enumerate(jax.random.split(key, S)):
        ks = jax.random.split(k, 7)
        for i, att in enumerate(T._ATTN):
            _fill_features(eps, s, layout, i, jax.random.normal(
                ks[i], (B, layout.features)))
            kq = jax.random.fold_in(ks[i], 10)
            for j, proj in enumerate(PROJ):
                kk = jax.random.fold_in(kq, j)
                for part, kp in (("kernel", kk),
                                 ("bias", jax.random.fold_in(kk, 1))):
                    shape = layout.offsets[(att, proj, part)][1]
                    _fill(eps, s, layout, (att, proj, part),
                          jax.random.normal(kp, shape))
        for i, fc in enumerate(T._FC):
            for j, part in enumerate(("kernel", "bias")):
                shape = layout.offsets[(fc, part)][1]
                _fill(eps, s, layout, (fc, part), jax.random.normal(
                    jax.random.fold_in(ks[3 + i], j), shape))
    return eps


def _jax_eps_unimodal(key, layout):
    """The unimodal JAX step's normals (``head_one`` of
    ``make_unimodal_dvp_predict_step``), in the port's draw layout."""
    eps = np.zeros((S, layout.head + B * layout.row), np.float32)
    for s, k in enumerate(jax.random.split(key, S)):
        _fill_features(eps, s, layout, 0,
                       jax.random.normal(k, (B, layout.features)))
        kf = jax.random.fold_in(k, 7)
        for part, kp in (("kernel", kf), ("bias", jax.random.fold_in(kf, 1))):
            shape = layout.offsets[("model", "fc", part)][1]
            _fill(eps, s, layout, ("model", "fc", part),
                  jax.random.normal(kp, shape))
    return eps


def _inject(monkeypatch, eps, seen=None):
    """Replace the port's split-sampler call by mean + scale * eps."""

    def draws(mean, scale, seed, num_draws, *, out_dtype, fast_math):
        assert (num_draws, mean.shape[0]) == eps.shape
        assert out_dtype == torch.float32 and not fast_math
        if seen is not None:
            seen.append(seed)
        return mean + scale * torch.from_numpy(eps)

    monkeypatch.setattr(T, "split_draws", draws)


@pytest.mark.parametrize("kind", ["multimodal", "unimodal"])
def test_dvp_step_matches_jax_under_its_noise(bundles, monkeypatch, kind):
    """The whole DVP step, the port's against JAX's, with JAX's normals
    (re-derived from the key) injected into the port's one draw: predicted
    class equal, mean_prob and both uncertainties to 1e-5 absolute."""
    key = jax.random.PRNGKey(3)
    if kind == "multimodal":
        jb, pb = bundles
        inputs = _inputs()
        jstep = J.make_dvp_predict_step(jb, S)
        step = T.make_dvp_predict_step(pb, S)
        eps = _jax_eps_multimodal(key, step.logits_fn.layout)
    else:
        jb = jmake_uni(3, 4, JSpec(), jax.random.PRNGKey(1), JARCH)
        jb = _with_mu(jb, lambda mu: mu * 4.0)
        pb = _carry(jb, ("unimodal", 3), num_classes=4)
        inputs = _inputs(channels=(3,))
        jstep = J.make_unimodal_dvp_predict_step(jb, S)
        step = T.make_unimodal_dvp_predict_step(pb, S)
        eps = _jax_eps_unimodal(key, step.logits_fn.layout)
    want = jstep(jb.post, jb.batch_stats, tuple(map(jnp.asarray, inputs)),
                 key)
    _inject(monkeypatch, eps)
    got = step(pb.post, pb.batch_stats, tuple(map(torch.from_numpy, inputs)),
               torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["predicted"].numpy(),
                                  np.asarray(want["predicted"]))
    # the outputs are far from uniform, so the columns compare something
    mean_prob = np.asarray(want["mean_prob"])
    assert np.abs(mean_prob - 1.0 / mean_prob.shape[1]).max() > 0.05
    for k in ("mean_prob", "predictive_uncertainty",
              "aleatoric_uncertainty", "csv_cols"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

def test_draws_are_one_split_sampler_call(bundles, monkeypatch):
    """One sampler call per batch, f32, on the seed words the step draws
    from its generator (``chunk_seed_words``): the draws equal
    ``split_plain`` at those words; the same generator seed gives the same
    outputs, another seed others."""
    _, pb = bundles
    x = tuple(map(torch.from_numpy, _inputs()))
    step = T.make_dvp_predict_step(pb, S)
    calls = []
    real = T.split_draws

    def recorded(mean, scale, seed, num_draws, **kw):
        out = real(mean, scale, seed, num_draws, **kw)
        calls.append((mean, scale, seed.clone(), out, kw))
        return out

    monkeypatch.setattr(T, "split_draws", recorded)
    run = lambda g: step(pb.post, pb.batch_stats, x,
                         torch.Generator().manual_seed(g))
    a, b, c = run(7), run(7), run(8)
    assert len(calls) == 3
    mean, scale, seed, out, kw = calls[0]
    assert kw == {"out_dtype": torch.float32, "fast_math": False}
    want_seed = torch.randint(0, 1 << 32, (1, 2), dtype=torch.int64,
                              generator=torch.Generator().manual_seed(7))[0]
    assert torch.equal(seed, want_seed)
    want = split_plain(mean, scale, tuple(seed.tolist()), S, torch.float32)
    assert torch.equal(out, torch.stack(want))
    assert torch.equal(calls[1][3], out) and not torch.equal(calls[2][3], out)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["mean_prob"], c["mean_prob"])


def test_head_gather_follows_packmeta(bundles):
    """Each head leaf's mean and scale sit in the draw vector at the offset
    the layout names and hold the packed elements PackMeta gives that leaf
    (sqrt of softplus(rho)^2); the features follow, one padded row per
    trunk and sample, and the pads are zero."""
    _, pb = bundles
    layout = T.make_dvp_logits_fn(pb, S).layout
    assert layout.head % 128 == 0 and layout.row % 128 == 0
    assert len(layout.ranges) == 2  # attention_* | trunks | fc* | trunks
    fm = torch.randn(3, B, layout.features, generator=torch.Generator()
                     .manual_seed(0))
    fv = torch.rand(3, B, layout.features)
    sigma = T.softplus(pb.post.rho)
    mean, scale = T.noise_vectors(layout, pb.post.mu, sigma * sigma, fm, fv)
    assert mean.shape == scale.shape == (layout.head + 3 * B * layout.row,)
    heads = {e.path: e for e in pb.meta.entries
             if e.path[0] in T._ATTN + T._FC}
    assert set(heads) == set(layout.offsets)
    for path, e in heads.items():
        off, shape = layout.offsets[path]
        assert shape == e.shape
        assert torch.equal(mean[off:off + e.size],
                           pb.post.mu[e.offset:e.offset + e.size])
        assert torch.equal(scale[off:off + e.size], torch.sqrt(
            (sigma * sigma)[e.offset:e.offset + e.size]))
    n_head = sum(e.size for e in heads.values())
    assert not mean[n_head:layout.head].any()
    rows = mean[layout.head:].view(3, B, layout.row)
    assert torch.equal(rows[..., :layout.features], fm)
    assert not rows[..., layout.features:].any()
    assert torch.equal(scale[layout.head:].view(3, B, layout.row)
                       [..., :layout.features], torch.sqrt(fv))


# ---------------------------------------------------------------------------
# the guardrail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread", [0.1, 0.5], ids=["moped", "spread"])
def test_guardrail_picks_jax_mode(bundles, spread):
    """sigma = s |mu| on either side of 0.15: ``posterior_spread`` equals
    JAX's to 1e-6 relative, and both packages build the same mode."""
    jb = _spread_to(bundles[0], spread)
    pb = _carry(jb)
    got = T.posterior_spread(pb.post, pb.meta)
    want = J.posterior_spread(jb.post, jb.meta)
    assert abs(got - want) <= 1e-6 * want
    assert (want > J.DVP_SPREAD_THRESHOLD) == (spread > 0.15)
    assert T.DVP_SPREAD_THRESHOLD == J.DVP_SPREAD_THRESHOLD
    _, jmode = J.make_dvp_predict_step(jb, 2, on_excess="mc",
                                       return_mode=True)
    _, tmode = T.make_dvp_predict_step(pb, 2, on_excess="mc",
                                       return_mode=True)
    assert tmode == jmode == ("mc" if spread > 0.15 else "dvp")


def test_guardrail_warn_fallback_and_arguments(bundles, caplog):
    """Above the threshold "warn" logs and builds DVP; "mc" builds a step
    whose outputs equal ``make_packed_predict_step``'s (or
    ``make_predict_step``'s) bit for bit at the same seeds, with
    ``mc_chunk`` reaching it; an unknown ``on_excess`` raises; ``spread=``
    replaces the measurement; ``return_mode`` returns (step, mode)."""
    pb = _carry(_spread_to(bundles[0], 0.5))
    with pytest.raises(ValueError, match="on_excess"):
        T.make_dvp_predict_step(pb, 2, on_excess="ignore")
    with caplog.at_level(logging.WARNING):
        step = T.make_dvp_predict_step(pb, 2)
    assert any("guardrail" in r.message for r in caplog.records)
    assert hasattr(step, "logits_fn")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        _, mode = T.make_dvp_predict_step(pb, 2, on_excess="mc", spread=0.1,
                                          return_mode=True)
    assert mode == "dvp" and not caplog.records

    rng = np.random.default_rng(0)
    u8 = tuple(torch.from_numpy(rng.integers(0, 256, (2, 32, 32, c),
                                             dtype=np.uint8))
               for c in (3, 3, 1))
    mask = torch.tensor([True, False])
    for packed, make in ((True, make_packed_predict_step),
                         (False, make_predict_step)):
        x = u8 if packed else tuple(t.float() / 255 for t in u8)
        step, mode = T.make_dvp_predict_step(
            pb, 4, on_excess="mc", packed_inputs=packed, mc_chunk=4,
            return_mode=True)
        assert mode == "mc"
        got = step(pb.post, pb.batch_stats, x,
                   torch.Generator().manual_seed(5), mask)
        want = make(pb, 4, mc_chunk=4)(pb.post, pb.batch_stats, x,
                                       torch.Generator().manual_seed(5), mask)
        for k in want:
            assert torch.equal(got[k], want[k]), (packed, k)
    with pytest.raises(ValueError, match="divisible"):
        T.make_dvp_predict_step(pb, 4, on_excess="mc", packed_inputs=True,
                                mc_chunk=3)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["folders", "packed"])
def test_run_auv_inference_dvp(tmp_path, packed, caplog):
    """``run_auv_inference(use_dvp=True)`` on the CPU over a survey tree:
    the reference's CSV schema, one row per folder, finite values; the
    MOPED posterior stays under the guardrail (no fallback)."""
    import csv

    root = make_inference_tree(str(tmp_path / "dives"), n_samples=5)
    out = str(tmp_path / "out.csv")
    with caplog.at_level(logging.WARNING):
        run_auv_inference(root, batch_size=2, output_csv=out,
                          num_mc_samples=3, allow_random_init=True,
                          arch=ArchConfig.micro(), use_packed_loader=packed,
                          use_dvp=True, device="cpu")
    assert not any("guardrail" in r.message for r in caplog.records)
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == CSV_HEADER
    assert sorted(r[0] for r in rows[1:]) == [f"Frame_{i:04d}.jpg"
                                              for i in range(5)]
    vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    assert np.isfinite(vals).all()
    assert ((vals[:, 0] >= 0) & (vals[:, 0] < 7)).all()
    assert ((vals[:, 1:] >= 0).all()
            and (vals[:, 2] <= np.log(7) + 1e-4).all())
    assert os.path.exists(os.path.join(root, ".packed_cache_32",
                                       "pack_meta.json")) == packed
