"""The MC engine's variants against the JAX package's: antithetic draws,
the pipelined split path, per-draw remat, at the micro() geometry, 32 px.

The TPU's noise cannot be reproduced, so where the two packages are
compared their samplers (or the port's one eps function) are replaced, in
that test only, by the same numpy or JAX draws. The port's own contracts
(pipelined == split bit for bit, mirror rows, the rows an mc rank draws,
launch counts) run on the plain versions of the kernels.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.engine.mc as torch_mc
import multimodal_auv_torch.ops.sampling as torch_sampling
import multimodal_auv_tpu.engine.mc as jax_mc
from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.predict import (
    make_packed_predict_step,
    make_predict_step,
)
from multimodal_auv_torch.engine.steps import make_elbo_loss_fn
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.ops.sampling import chunk_seeds
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.engine.predict import (
    make_predict_step as jmake_predict_step,
)
from multimodal_auv_tpu.engine.steps import make_elbo_loss_fn as jelbo
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake

# logits of the two packages on the same weights: f32 forwards through
# micro()'s two stages, reductions in another order
LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundles():
    """The JAX micro() bundle and the port's copy of it (interop)."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  np_tree(jb.post.det), np_tree(jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=7, arch=ArchConfig.micro(), device="cpu")
    return jb, pb


def _inputs(seed, batch=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, size, size, c)).astype(np.float32)
            for c in (3, 3, 1)]


def _draws(jb, n, seed, dtype):
    """n numpy draws mu + sigma * z of the JAX posterior, as (n, P) f32
    values rounded to ``dtype``."""
    mu = np.asarray(jb.post.mu)
    sigma = np.asarray(jax.nn.softplus(jb.post.rho))
    z = np.random.default_rng(seed).standard_normal((n,) + mu.shape)
    w = (mu + sigma * z).astype(np.float32)
    return torch.from_numpy(w).to(dtype).to(torch.float32).numpy()


@pytest.mark.parametrize("sample_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mc_chunk", [1, 2])
def test_antithetic_logits_equal_jax(monkeypatch, bundles, mc_chunk,
                                     sample_dtype):
    """``mc_logits(antithetic=True)`` at 4 draws (chunks of mc_chunk
    sampled rows, each followed by its mirrors): both stacked samplers
    return the same numpy draws, each package forms the mirrors 2 mu - w
    from its own sampling mu (bf16-cast under ``sample_dtype``), and the
    logits agree to LOGIT_ATOL. The split hint gives way (the stacked
    sampler runs)."""
    jb, pb = bundles
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[sample_dtype]
    draws = _draws(jb, mc_chunk, 4, tdt or torch.float32)
    calls = {"jax": 0, "torch": 0}

    def jax_sampler(mu, sigma, key, num_draws=None, *, impl, out_dtype):
        assert num_draws == mc_chunk
        calls["jax"] += 1
        return jnp.asarray(draws).astype(out_dtype or jnp.float32)

    def torch_sampler(mu, sigma, seed, num_draws, *, out_dtype):
        assert num_draws == mc_chunk
        calls["torch"] += 1
        return torch.from_numpy(draws).to(out_dtype or torch.float32)

    monkeypatch.setattr(jax_mc, "gaussian_shift_scale", jax_sampler)
    monkeypatch.setattr(torch_mc, "gaussian_shift_scale", torch_sampler)
    x = _inputs(1)
    want = np.asarray(jax_mc.mc_logits(
        jb.module, jb.meta, jb.post, jb.batch_stats,
        tuple(jnp.asarray(a) for a in x), jax.random.PRNGKey(3), 4,
        mc_chunk=mc_chunk, impl="jnp", remat=False, sample_dtype=jdt,
        antithetic=True, split_sampling=True), np.float32)
    with torch.no_grad():
        got = torch_mc.mc_logits(
            pb.module, pb.meta, pb.post, pb.batch_stats,
            [torch.from_numpy(a) for a in x],
            torch.Generator().manual_seed(3), 4, mc_chunk=mc_chunk,
            remat=False, sample_dtype=tdt, antithetic=True,
            split_sampling=True).to(torch.float32).numpy()
    assert got.shape == want.shape == (4, 2, 7)
    assert calls["torch"] == 4 // (2 * mc_chunk) and calls["jax"] >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert not np.allclose(got[0], got[mc_chunk], atol=1e-3)


def test_antithetic_predict_step_equals_jax(monkeypatch, bundles):
    """``make_predict_step(antithetic=True)`` (bf16 weights, chunk 1 by
    default: 2 draws per chunk) on a ragged batch (mask [1, 1, 0]) against
    the JAX step under the same injected draws: predicted classes equal,
    uncertainties and mean probabilities to LOGIT_ATOL."""
    jb, pb = bundles
    draws = _draws(jb, 1, 5, torch.bfloat16)
    monkeypatch.setattr(
        jax_mc, "gaussian_shift_scale",
        lambda mu, sigma, key, num_draws=None, *, impl, out_dtype:
        jnp.asarray(draws).astype(out_dtype))
    monkeypatch.setattr(
        torch_mc, "gaussian_shift_scale",
        lambda mu, sigma, seed, num_draws, *, out_dtype:
        torch.from_numpy(draws).to(out_dtype))
    x = _inputs(2, batch=3)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jstep = jmake_predict_step(jb, 6, impl="jnp", antithetic=True)
    want = jstep(jb.post, jb.batch_stats, tuple(jnp.asarray(a) for a in x),
                 jax.random.PRNGKey(0), jnp.asarray(mask))
    step = make_predict_step(pb, 6, antithetic=True)
    got = step(pb.post, pb.batch_stats, [torch.from_numpy(a) for a in x],
               torch.Generator().manual_seed(0), torch.from_numpy(mask))
    np.testing.assert_array_equal(got["predicted"].numpy()[:2],
                                  np.asarray(want["predicted"])[:2])
    for name in ("predictive_uncertainty", "aleatoric_uncertainty",
                 "mean_prob"):
        np.testing.assert_allclose(
            got[name].to(torch.float32).numpy()[:2],
            np.asarray(want[name], np.float32)[:2], rtol=0,
            atol=LOGIT_ATOL, err_msg=name)


def test_pipelined_logits_equal_jax(monkeypatch, bundles):
    """``mc_logits(pipelined=True)``, 6 draws in chunks of 2 (3 chunks),
    bf16 weights: both split samplers return the same numpy draws, and the
    JAX pipelined scan and the port's pipelined loop give logits that
    agree to LOGIT_ATOL, chunk by chunk in the split path's order."""
    jb, pb = bundles
    draws = _draws(jb, 2, 6, torch.bfloat16)
    calls = {"jax": 0, "torch": 0}

    def jax_split(mu, sigma, key, num_draws, *, impl, out_dtype, fast_math):
        assert num_draws == 2 and fast_math
        calls["jax"] += 1
        return [jnp.asarray(d).astype(out_dtype) for d in draws]

    def torch_split(mu, sigma, seed, num_draws, *, out_dtype, fast_math):
        assert num_draws == 2 and fast_math
        calls["torch"] += 1
        return [torch.from_numpy(d).to(out_dtype) for d in draws]

    monkeypatch.setattr(jax_mc, "gaussian_shift_scale_split", jax_split)
    monkeypatch.setattr(torch_mc, "gaussian_shift_scale_split", torch_split)
    x = _inputs(3)
    want = np.asarray(jax_mc.mc_logits(
        jb.module, jb.meta, jb.post, jb.batch_stats,
        tuple(jnp.asarray(a) for a in x), jax.random.PRNGKey(1), 6,
        mc_chunk=2, impl="jnp", remat=False, sample_dtype=jnp.bfloat16,
        pipelined=True, split_sampling=True), np.float32)
    with torch.no_grad():
        got = torch_mc.mc_logits(
            pb.module, pb.meta, pb.post, pb.batch_stats,
            [torch.from_numpy(a) for a in x],
            torch.Generator().manual_seed(1), 6, mc_chunk=2, remat=False,
            sample_dtype=torch.bfloat16, pipelined=True,
            split_sampling=True).to(torch.float32).numpy()
    assert calls["torch"] == 3 and calls["jax"] >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def port_bundle():
    return make_multimodal_bundle(7, BNNPriorSpec(),
                                  torch.Generator().manual_seed(0),
                                  ArchConfig.micro(), device="cpu")


@pytest.mark.parametrize("num_mc,mc_chunk", [(4, 1), (6, 2), (6, 3)])
def test_pipelined_bit_equal_split(monkeypatch, port_bundle, num_mc,
                                   mc_chunk):
    """The pipelined path draws what the split path draws, in its order,
    so the logits are equal bit for bit, through ``mc_logits`` and through
    the packed predict step (uint8 inputs, a ragged mask)."""
    b = port_bundle
    ran = []
    real = torch_mc._pipelined
    monkeypatch.setattr(torch_mc, "_pipelined",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    x = [torch.from_numpy(a) for a in _inputs(7)]
    kw = dict(mc_chunk=mc_chunk, remat=False, sample_dtype=torch.bfloat16)
    with torch.no_grad():
        split = torch_mc.mc_logits(
            b.module, b.meta, b.post, b.batch_stats, x,
            torch.Generator().manual_seed(5), num_mc, split_sampling=True,
            **kw)
        pipe = torch_mc.mc_logits(
            b.module, b.meta, b.post, b.batch_stats, x,
            torch.Generator().manual_seed(5), num_mc, pipelined=True, **kw)
    assert torch.equal(split, pipe)
    rng = np.random.default_rng(8)
    u8 = [torch.from_numpy(rng.integers(0, 256, (3, 32, 32, c),
                                        dtype=np.uint8)) for c in (3, 3, 1)]
    mask = torch.tensor([True, True, False])
    outs = [make_packed_predict_step(b, num_mc, mc_chunk=mc_chunk,
                                     pipelined=p)(
        b.post, b.batch_stats, u8, torch.Generator().manual_seed(2), mask)
        for p in (False, True)]
    for name in ("csv_cols", "mean_prob"):
        assert torch.equal(outs[0][name], outs[1][name]), name
    assert len(ran) == 2


def _one_rank_mesh():
    from multimodal_auv_torch.parallel.mesh import make_mesh

    return make_mesh()


@pytest.mark.parametrize("case", ["remat_recording", "antithetic", "mc_axis",
                                  "chained_bn", "single_chunk"])
def test_pipelined_inactive(monkeypatch, port_bundle, case):
    """The pipelined hint gives way, as in the JAX package, under remat
    while gradients are recorded, antithetic draws, an mc axis, chained BN
    and a single chunk: the pipeline never runs, and the logits are those
    of the same call without the hint."""
    b = port_bundle
    ran = []
    real = torch_mc._pipelined
    monkeypatch.setattr(torch_mc, "_pipelined",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    x = [torch.from_numpy(a) for a in _inputs(9)]
    kw = dict(mc_chunk=1, remat=False)
    num_mc = 2
    post = b.post
    if case == "remat_recording":
        post = PackedPosterior(b.post.mu.clone().requires_grad_(),
                               b.post.rho.clone().requires_grad_(),
                               b.post.det)
        kw["remat"] = True
    elif case == "antithetic":
        kw["antithetic"] = True
    elif case == "mc_axis":
        kw["ws_sharding"] = _one_rank_mesh()
    elif case == "chained_bn":
        kw["return_batch_stats"] = True
    else:
        num_mc, kw["mc_chunk"] = 2, 2

    def run(**extra):
        out = torch_mc.mc_logits(b.module, b.meta, post, b.batch_stats, x,
                                 torch.Generator().manual_seed(4), num_mc,
                                 **kw, **extra)
        return out[0] if isinstance(out, tuple) else out

    with torch.set_grad_enabled(case == "remat_recording"):
        got, want = run(pipelined=True), run()
    assert not ran
    assert torch.equal(got.detach(), want.detach())


def _capture_module(n):
    """A module and meta whose 'logits' are the first n elements of each
    draw's weights (batch 1), so ``mc_logits`` returns the rows it drew."""
    meta = SimpleNamespace(unpack=lambda w, det: w)
    module = lambda w, bs, *inputs, **kw: w[None, :n].to(torch.float32)
    return module, meta


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_antithetic_mirror_rows(dtype):
    """A chunk's rows are [ws; (2 mu - ws)] with the mirrors formed in f32
    from the sampling mu and cast to the draws' dtype, bit for bit; one
    stacked sampling per chunk."""
    P = 2048
    g = torch.Generator().manual_seed(0)
    post = PackedPosterior(torch.randn(P, generator=g),
                           torch.randn(P, generator=g) - 3.0, {})
    sdt = {"f32": None, "bf16": torch.bfloat16}[dtype]
    module, meta = _capture_module(P)
    with torch.no_grad():
        rows = torch_mc.mc_logits(module, meta, post, {}, [],
                                  torch.Generator().manual_seed(1), 8,
                                  mc_chunk=2, remat=False, sample_dtype=sdt,
                                  antithetic=True)[:, 0]
    mu, sigma = torch_mc._sampling_posterior(post, sdt)
    seeds = chunk_seeds(torch.Generator().manual_seed(1), 2)
    for c, seed in enumerate(seeds):
        ws = torch_sampling.gaussian_shift_scale(mu, sigma, seed, 2,
                                                 out_dtype=sdt)
        mirror = (2.0 * mu.to(torch.float32)
                  - ws.to(torch.float32)).to(ws.dtype)
        want = torch.cat([ws, mirror]).to(torch.float32)
        assert torch.equal(rows[4 * c:4 * c + 4], want), c


@pytest.mark.parametrize("mc_chunk,mc", [(1, 2), (3, 2), (3, 3), (2, 4)])
def test_antithetic_rows_of_an_mc_rank(monkeypatch, mc_chunk, mc):
    """Under an mc axis of ``mc`` ranks, rank m's rows of each antithetic
    chunk equal rows [m k, (m + 1) k) of the unsharded [ws; mirror] stack
    (k = 2 mc_chunk / mc): a rank whose rows are mirrors draws the rows
    they mirror from the chunk's seed with the draw offset folded in. The
    gather is replaced by one that keeps each rank's own rows."""
    P = 2048
    g = torch.Generator().manual_seed(2)
    post = PackedPosterior(torch.randn(P, generator=g),
                           torch.randn(P, generator=g) - 3.0, {})
    module, meta = _capture_module(P)
    kw = dict(mc_chunk=mc_chunk, remat=False, antithetic=True)
    num_mc = 4 * mc_chunk
    with torch.no_grad():
        full = torch_mc.mc_logits(module, meta, post, {}, [],
                                  torch.Generator().manual_seed(3), num_mc,
                                  **kw)[:, 0]
    mine = {}

    def keep_own(x, axis):
        mine[axis.index] = x.clone()
        return x.repeat((axis.size,) + (1,) * (x.dim() - 1))

    monkeypatch.setattr(torch_mc, "gather_draws", keep_own)
    k = 2 * mc_chunk // mc
    for m in range(mc):
        axis = SimpleNamespace(size=mc, index=m)
        with torch.no_grad():
            torch_mc.mc_logits(module, meta, post, {}, [],
                               torch.Generator().manual_seed(3), num_mc,
                               ws_sharding=SimpleNamespace(mc_axis=axis),
                               **kw)
        for c in range(2):
            want = full[2 * mc_chunk * c + m * k:2 * mc_chunk * c
                        + (m + 1) * k]
            assert torch.equal(mine[m][c * k:(c + 1) * k, 0], want), (m, c)


def _counting(monkeypatch):
    """Count the stacked sampler's and the eps function's calls (the
    kernels #2 and #3 launch at these call sites on the card)."""
    counts = {"stacked": 0, "eps": 0}
    stacked, noise = torch_sampling.stacked_plain, torch_sampling.gaussian_noise

    def count_stacked(*a, **k):
        counts["stacked"] += 1
        return stacked(*a, **k)

    def count_eps(*a, **k):
        counts["eps"] += 1
        return noise(*a, **k)

    monkeypatch.setattr(torch_sampling, "stacked_plain", count_stacked)
    monkeypatch.setattr(torch_sampling, "gaussian_noise", count_eps)
    return counts


def _loss_and_grads(b, remat, mc_chunk, num_mc, x, labels, mask):
    post = PackedPosterior(b.post.mu.clone().requires_grad_(),
                           b.post.rho.clone().requires_grad_(), b.post.det)
    loss_fn = make_elbo_loss_fn(b.module, b.meta, BNNPriorSpec(), num_mc,
                                mc_chunk=mc_chunk, packed_inputs=True,
                                remat=remat)
    loss, (_, ce, _, new_bs) = loss_fn(
        post, b.batch_stats, x, labels, mask,
        torch.Generator().manual_seed(9), 1e-6, 3.0)
    loss.backward()
    return loss.detach(), post.mu.grad, post.rho.grad, new_bs


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _u8(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
            for c in (3, 3, 1)]


def test_per_draw_remat_equals_remat_off_and_counts(monkeypatch,
                                                    port_bundle):
    """10 draws in chunks of 5 (above the 4 forwards a chunk may run
    inside one checkpoint): per-draw remat samples each chunk once and
    keeps the stack, so the step makes 2 stacked samplings and 2 eps
    regenerations (chunks of 1 under remat: 20 and 10), and its loss,
    mu / rho gradients and chained BN statistics equal remat off's bit
    for bit (the same operations on the CPU)."""
    b = port_bundle
    x = [torch.from_numpy(a) for a in _u8(1)]
    labels, mask = torch.tensor([0, 3, 3]), torch.tensor([1.0, 1.0, 0.0])
    counts = _counting(monkeypatch)
    on = _loss_and_grads(b, True, 5, 10, x, labels, mask)
    assert counts == {"stacked": 2, "eps": 2}
    off = _loss_and_grads(b, False, 5, 10, x, labels, mask)
    assert counts == {"stacked": 4, "eps": 4}
    for a, c in zip(on[:3], off[:3]):
        assert torch.equal(a, c)
    want = dict(_flat(off[3]))
    for path, leaf in _flat(on[3]):
        assert torch.equal(leaf, want[path]), path
    counts.update(stacked=0, eps=0)
    _loss_and_grads(b, True, 1, 10, x, labels, mask)
    assert counts == {"stacked": 20, "eps": 10}


def test_per_draw_remat_equals_jax(monkeypatch, bundles):
    """The loss the train step differentiates, 10 draws in chunks of 5,
    remat on (per-draw checkpoints in both packages), chained BN, a ragged
    batch: under the same eps (JAX's ``jax.random.normal`` of each chunk's
    key, injected into the port by the chunk's seed) the loss agrees to
    rtol 1e-4 and every mu / rho gradient to rtol 2e-2 with a floor of
    1e-3 of its leaf's largest (tests/test_torch_train.py's criterion)."""
    jb, pb = bundles
    P = pb.meta.n_padded
    u8 = _u8(2)
    labels = np.array([1, 4, 4], np.int32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(11)
    seeds = chunk_seeds(torch.Generator().manual_seed(9), 2)
    chunk_keys = dict(zip(seeds, jax.random.split(key, 2)))

    def jax_eps(P_, seed, num_draws, device=None, noise="f32"):
        assert noise == "f32" and P_ == P and num_draws == 5
        eps = jax.random.normal(chunk_keys[tuple(seed)], (num_draws, P_),
                                jnp.float32)
        return torch.from_numpy(np.array(eps)).to(device)

    monkeypatch.setattr(torch_sampling, "eps_plain", jax_eps)
    grad_fn = jax.jit(jax.value_and_grad(
        jelbo(jb.module, jb.meta, JSpec(), 10, mc_chunk=5, impl="jnp",
              packed_inputs=True), has_aux=True))
    (jloss, _), jgrads = grad_fn(
        jb.post, jb.batch_stats, tuple(jnp.asarray(a) for a in u8),
        jnp.asarray(labels), jnp.asarray(mask), key, jnp.float32(1e-6),
        jnp.float32(3.0))
    loss, gmu, grho, _ = _loss_and_grads(
        pb, True, 5, 10, [torch.from_numpy(a) for a in u8],
        torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for e in pb.meta.entries:
        sl = slice(e.offset, e.offset + e.size)
        for got, want, name in ((gmu, jgrads.mu, "dmu"),
                                (grho, jgrads.rho, "drho")):
            want = np.asarray(want)[sl]
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got.numpy()[sl], want, rtol=2e-2,
                                       atol=1e-3 * scale,
                                       err_msg=f"{name}{e.path}")


def test_antithetic_refusals(port_bundle):
    """As in the JAX package: num_mc must divide by 2 x mc_chunk, and
    antithetic draws cannot chain BN statistics."""
    b = port_bundle
    x = [torch.from_numpy(a) for a in _inputs(0)]
    run = lambda **kw: torch_mc.mc_logits(
        b.module, b.meta, b.post, b.batch_stats, x,
        torch.Generator().manual_seed(0), 6, antithetic=True, remat=False,
        **kw)
    with pytest.raises(ValueError, match="2\\*mc_chunk"):
        run(mc_chunk=2)
    with pytest.raises(ValueError, match="antithetic"):
        run(mc_chunk=1, return_batch_stats=True)
