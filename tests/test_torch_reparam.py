"""The port's kernel #4 path — ``gaussian_reparam`` (the plain version of the
reparam kernel), ``bayes.sample_weights`` and ``ModelBundle.sample_and_apply``
— against the JAX package's.

As for kernels #1-#3, the TPU's random bits cannot be reproduced: the plain
version is held to JAX's ``_reparam_kernel`` in interpret mode (which stubs
its bits to zero) on zero bits, to the stacked sampler on the port's own
noise, and, with eps drawn by ``jax.random.normal`` injected into both, to
JAX's ``impl="jnp"`` path. The CUDA kernel is held bit for bit against the
plain version on the card, in tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, sample_weights
from multimodal_auv_torch.engine.mc import chunk_seeds
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import sampling as S
from multimodal_auv_tpu.bayes import sample_weights as jsample_weights
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_unimodal_bundle as jmake
from multimodal_auv_tpu.ops import sampling as J

RAGGED_P = 512 * 128 + 1024  # one full block and a partial one


def _ulps(a, b):
    """Distance in f32 units in the last place (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _rho_span(n, seed):
    """rho over [-30, 25]: both branches of softplus_k (x > 20 and not)."""
    return np.random.default_rng(seed).uniform(-30, 25, n).astype(np.float32)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_zero_bits_reparam_matches_jax_interpret(monkeypatch, out_dtype):
    """Zero random bits through the port's plain ``gaussian_reparam`` equal
    JAX's ``_reparam_kernel`` in interpret mode, 2 draws, rho over
    [-30, 25], at a P whose last block is partial. Tolerances of
    tests/test_torch_train_sampling.py: XLA:CPU may contract mu + sigma *
    eps into one FMA where the port rounds twice, and the two softplus
    forms differ by up to 3 ulp (see the softplus test): rtol 1e-6,
    atol 1e-6 in f32, one bf16 ulp (rtol 2^-7) in bf16."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    rng = np.random.default_rng(4)
    mu = rng.standard_normal(RAGGED_P).astype(np.float32)
    rho = _rho_span(RAGGED_P, 5)
    rows = RAGGED_P // S.LANES
    seed = J._seed_from_key(jax.random.PRNGKey(0))
    want = J._pallas_reparam(
        jnp.asarray(mu).reshape(rows, S.LANES),
        jnp.asarray(rho).reshape(rows, S.LANES), seed, 2, jdt,
        kernel=J._reparam_kernel, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(2, RAGGED_P)

    nblk = -(-RAGGED_P // S.BLOCK_ELEMS)
    zero = torch.zeros((nblk, S.PAIRS_PER_BLOCK), dtype=torch.int64)
    zero_eps = S.block_noise(zero, zero, RAGGED_P)
    monkeypatch.setattr(S, "eps_plain", lambda P, seed, n, device=None,
                        noise="f32": zero_eps.expand(n, P).to(device))
    got = S.gaussian_reparam(torch.from_numpy(mu), torch.from_numpy(rho),
                             (0, 0), 2, out_dtype=tdt)
    got = got.to(torch.float32).numpy()
    assert np.abs(want).max() > 100.0  # sigma up to 25 times eps ~ 5.77
    if out_dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_draws", [None, 1, 3])
def test_reparam_noise_contract(num_draws):
    """``reparam_plain(mu, rho)`` is ``stacked_plain(mu, softplus_k(rho))``
    bit for bit, so ``gaussian_reparam`` is ``gaussian_shift_scale`` at
    sigma = softplus_k(rho), in f32 and bf16; (P,) without ``num_draws``;
    no kernel launch on the CPU. P = 2048, one partial block."""
    P = 2048
    mu = torch.from_numpy(np.random.default_rng(6).standard_normal(
        P).astype(np.float32))
    rho = torch.from_numpy(_rho_span(P, 7))
    n = 1 if num_draws is None else num_draws
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        want = S.gaussian_shift_scale(mu, S.softplus_k(rho), (11, 3), n)
    assert torch.equal(S.reparam_plain(mu, rho, (11, 3), n, torch.float32),
                       want)
    got = S.gaussian_reparam(mu, rho, (11, 3), num_draws)
    assert got.shape == ((P,) if num_draws is None else (n, P))
    assert torch.equal(got.reshape(n, P), want)
    bf = S.gaussian_reparam(mu.bfloat16(), rho.bfloat16(), (11, 3), n)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, S.stacked_plain(
        mu.bfloat16(), S.softplus_k(rho.bfloat16()), (11, 3), n,
        torch.bfloat16))
    assert kernels.LAUNCHES == before


def test_softplus_k_against_jax_softplus():
    """softplus_k against ``_softplus`` on 3M f32 points over [-30, 25].
    Measured on this package's CPU build: softplus_k is within 1 ulp of
    the correctly rounded softplus (f64), while XLA:CPU's ``_softplus`` is
    within 3 (its log1p is 2 ulp off), so the two agree to 3 ulp, not 1.
    The two JAX forms, ``_softplus`` and ``jax.nn.softplus``, differ by up
    to 3 ulp as well; softplus_k is ``_softplus``'s form, the f32 where
    with its x > 20 branch exact."""
    rng = np.random.default_rng(8)
    x = np.concatenate([np.linspace(-30, 25, 2_000_001, dtype=np.float32),
                        rng.uniform(-30, 25, 1_000_000).astype(np.float32),
                        np.float32([20.0, np.nextafter(np.float32(20), 30),
                                    np.nextafter(np.float32(20), 0)])])
    port = S.softplus_k(torch.from_numpy(x)).numpy()
    jaxk = np.asarray(jax.jit(J._softplus)(jnp.asarray(x)))
    jnn = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    xm = np.minimum(x, 20).astype(np.float64)
    exact = np.where(x > 20, x, np.log1p(np.exp(xm))).astype(np.float32)
    assert _ulps(port, exact).max() <= 1
    assert _ulps(jaxk, exact).max() <= 3
    assert _ulps(port, jaxk).max() <= 3
    assert _ulps(jaxk, jnn).max() <= 3
    big = x > 20
    assert np.array_equal(port[big], x[big]) and np.array_equal(jaxk[big],
                                                                x[big])


def test_grad_refused():
    """No backward, as JAX's ``_reparam_kernel`` has no VJP: with grad mode
    on and mu or rho requiring grad, ValueError, not a detached tensor;
    under ``torch.no_grad()`` it samples."""
    mu = torch.zeros(1024, requires_grad=True)
    rho = torch.zeros(1024)
    with pytest.raises(ValueError, match="no backward"):
        S.gaussian_reparam(mu, rho, (1, 2))
    with pytest.raises(ValueError, match="no backward"):
        S.gaussian_reparam(mu.detach(), rho.requires_grad_(), (1, 2), 2)
    post = PackedPosterior(mu, torch.zeros(1024), {})
    with pytest.raises(ValueError, match="no backward"):
        sample_weights(post, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert sample_weights(post, torch.Generator()).shape == (1024,)


@pytest.fixture(scope="module")
def tiny_bundles():
    jb = jmake(3, 7, JSpec(), jax.random.PRNGKey(1), JArch.tiny())
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  jax.tree_util.tree_map(np.asarray, jb.post.det),
                  jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=7, arch=ArchConfig.tiny(), kind=("unimodal", 3),
                  device="cpu")
    return jb, pb


def _inject_jax_eps(monkeypatch, generator_seed, key):
    """Replace the port's one eps function by ``jax.random.normal(key)``
    for the seed pair that ``generator_seed``'s generator draws first."""
    (seed,) = chunk_seeds(torch.Generator().manual_seed(generator_seed), 1)
    calls = []

    def jax_eps(P, s, n, device=None, noise="f32"):
        assert tuple(s) == seed and noise == "f32"
        calls.append(n)
        eps = jax.random.normal(key, (n, P), jnp.float32)
        return torch.from_numpy(np.array(eps)).to(device)

    monkeypatch.setattr(S, "eps_plain", jax_eps)
    return calls


def test_sample_weights_equals_jax_under_injected_eps(monkeypatch,
                                                      tiny_bundles):
    """One draw of a tiny() unimodal posterior (MOPED rho and the prior
    pad) and of rho over [-30, 25], port against JAX's
    ``sample_weights(impl="jnp")``, with the same eps. The jnp path takes
    ``jax.nn.softplus``, the port softplus_k (up to 3 ulp apart, see
    above), and XLA may fuse the multiply-add: per element |w - w_jax| <=
    4 ulp(sigma) |eps| + ulp(w)."""
    jb, pb = tiny_bundles
    key = jax.random.PRNGKey(3)
    P = pb.meta.n_padded
    rho_span = _rho_span(P, 9)
    for rho in (np.array(jb.post.rho), rho_span):
        calls = _inject_jax_eps(monkeypatch, 12, key)
        post = PackedPosterior(pb.post.mu, torch.from_numpy(rho), {})
        got = sample_weights(post, torch.Generator().manual_seed(12)).numpy()
        jpost = type(jb.post)(mu=jb.post.mu, rho=jnp.asarray(rho),
                              det=jb.post.det)
        want = np.asarray(jsample_weights(jpost, key, impl="jnp"))
        assert calls == [1] and got.shape == want.shape == (P,)
        eps = np.asarray(jax.random.normal(key, (1, P)))[0]
        sigma = S.softplus_k(torch.from_numpy(rho)).numpy()
        ulp = lambda v: np.spacing(np.abs(v).astype(np.float32))
        bound = 4 * ulp(sigma) * np.abs(eps) + ulp(want)
        assert np.all(np.abs(got - want) <= bound)


def test_sample_and_apply_equals_jax_under_injected_eps(monkeypatch,
                                                        tiny_bundles):
    """``sample_and_apply`` (train-mode BN, ``mutable``) on a tiny() 3-channel
    ``ResNet50Custom`` carried from JAX, with eps injected: logits at rtol
    1e-4 / atol 1e-5 (the forward's tolerance, tests/test_torch_models.py),
    the new running statistics at atol 1e-5; ``apply_mean`` in eval mode
    against JAX's at the same tolerance."""
    jb, pb = tiny_bundles
    key = jax.random.PRNGKey(4)
    x = np.random.default_rng(10).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    calls = _inject_jax_eps(monkeypatch, 13, key)
    with torch.no_grad():
        got, new = pb.sample_and_apply(torch.Generator().manual_seed(13),
                                       torch.from_numpy(x), mutable=True)
    want, jnew = jb.sample_and_apply(key, jnp.asarray(x), impl="jnp",
                                     mutable=True)
    assert calls == [1] and got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    jflat = jax.tree_util.tree_leaves_with_path(jnew["batch_stats"])
    assert len(jflat) > 10
    for path, leaf in jflat:
        node = new
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), rtol=0,
                                   atol=1e-5, err_msg=str(path))
    with torch.no_grad():
        mean = pb.apply_mean(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(jb.apply_mean(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
