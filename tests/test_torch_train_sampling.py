"""The port's training sampler (stacked kernel #2, eps kernel #3 and the
autograd Function over them) against the JAX package's.

As for the split sampler (tests/test_torch_sampling.py), the TPU's random
bits cannot be reproduced: the plain versions are held to the JAX kernels
in interpret mode (which stub their bits to zero) on zero bits, and to
each other and to autograd on the port's own noise. The CUDA kernels are
held bit for bit against the plain versions on the card, in
tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import sampling as S
from multimodal_auv_tpu.ops import sampling as J

RAGGED_P = 512 * 128 + 1024  # one full block and a partial one


def _zero_bits_eps(P, num_draws):
    nblk = -(-P // S.BLOCK_ELEMS)
    zero = torch.zeros((nblk, S.PAIRS_PER_BLOCK), dtype=torch.int64)
    return S.block_noise(zero, zero, P).expand(num_draws, P)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_zero_bits_stacked_matches_jax_interpret(out_dtype):
    """Zero random bits through the port's stacked arithmetic equal JAX's
    ``_reparam_sigma_kernel`` in interpret mode, 2 draws, at a P whose last
    block is partial. Tolerance: XLA:CPU may contract mu + sigma * eps into
    one FMA where the port rounds twice: one rounding of |w| < 8 in f32
    (rtol 1e-6, atol 1e-6), one bf16 ulp in bf16 (rtol 2^-7)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    rng = np.random.default_rng(3)
    mu = rng.standard_normal(RAGGED_P).astype(np.float32)
    sg = rng.uniform(0.01, 0.5, RAGGED_P).astype(np.float32)
    rows = RAGGED_P // S.LANES
    seed = J._seed_from_key(jax.random.PRNGKey(0))
    want = J._pallas_reparam(
        jnp.asarray(mu).reshape(rows, S.LANES),
        jnp.asarray(sg).reshape(rows, S.LANES), seed, 2, jdt,
        kernel=J._reparam_sigma_kernel, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(2, RAGGED_P)
    eps = _zero_bits_eps(RAGGED_P, 2)
    got = (torch.from_numpy(mu) + torch.from_numpy(sg) * eps).to(tdt)
    got = got.to(torch.float32).numpy()
    if out_dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_zero_bits_eps_matches_jax_interpret():
    """The port's eps layout from zero bits equals JAX's ``_eps_kernel`` in
    interpret mode (rtol 1e-6: XLA:CPU may contract the polynomials'
    multiply-adds into FMAs)."""
    seed = J._seed_from_key(jax.random.PRNGKey(0))
    want = np.asarray(J._pallas_eps(RAGGED_P, seed, 3, jnp.float32,
                                    interpret=True))
    got = _zero_bits_eps(RAGGED_P, 3).numpy()
    assert np.abs(want).max() > 5.0  # the cos half: r at u1 = 2^-24
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num_draws", [1, 3])
def test_stacked_split_and_eps_share_noise(num_draws):
    """At (mu, sigma) = (0, 1) the stacked sampler, the split sampler (f32
    noise) and the eps function give the same numbers bit for bit, and the
    CPU path launches no kernel."""
    z, o = torch.zeros(RAGGED_P), torch.ones(RAGGED_P)
    before = dict(kernels.LAUNCHES)
    eps = S.gaussian_noise(RAGGED_P, (5, 8), num_draws, "cpu")
    stacked = S.gaussian_shift_scale(z, o, (5, 8), num_draws)
    split = S.gaussian_shift_scale_split(z, o, (5, 8), num_draws)
    assert stacked.shape == eps.shape == (num_draws, RAGGED_P)
    assert torch.equal(stacked, eps)
    assert all(torch.equal(s, e) for s, e in zip(split, eps))
    assert torch.equal(eps, S.eps_plain(RAGGED_P, (5, 8), num_draws))
    assert kernels.LAUNCHES == before


def test_vjp_matches_autograd_through_plain(monkeypatch):
    """The Function's (dmu, dsigma) equal autograd through
    mu + sigma * eps_plain (tests/test_sampling_vjp.py's check), its
    backward regenerates eps from the seed (one eps draw in the forward,
    one in the backward), and the forward saves no tensor for it."""
    P = 1024
    mu = torch.linspace(-1, 1, P).requires_grad_()
    sigma = torch.linspace(0.1, 0.5, P).requires_grad_()
    draws = []
    plain = S.eps_plain

    def counting(*a, **kw):
        draws.append(a[1])
        return plain(*a, **kw)

    monkeypatch.setattr(S, "eps_plain", counting)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        w = S.gaussian_shift_scale(mu, sigma, (1, 2), 4)
    assert saved == [] and draws == [(1, 2)]
    g1 = torch.autograd.grad((torch.sin(w) * w).sum(), (mu, sigma))
    assert draws == [(1, 2), (1, 2)]
    w2 = mu + sigma * plain(P, (1, 2), 4)
    g2 = torch.autograd.grad((torch.sin(w2) * w2).sum(), (mu, sigma))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_vjp_single_draw_bf16_output():
    """bf16 sampled weights give f32 gradients (mu's and sigma's dtype):
    sum over one draw of the ones cotangent is 1 for mu."""
    P = 256
    mu = torch.zeros(P, requires_grad=True)
    sigma = torch.full((P,), 0.3, requires_grad=True)
    w = S.gaussian_shift_scale(mu, sigma, (3, 1), 1, out_dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16
    gmu, gsg = torch.autograd.grad(w.sum(), (mu, sigma))
    assert gmu.dtype == gsg.dtype == torch.float32
    torch.testing.assert_close(gmu, torch.ones(P), rtol=0, atol=0)
    torch.testing.assert_close(gsg, S.eps_plain(P, (3, 1), 1)[0], rtol=0,
                               atol=0)


def test_fast_math_refused_on_differentiable_path():
    mu = torch.zeros(1024)
    with pytest.raises(ValueError, match="differentiable path"):
        S.gaussian_shift_scale(mu, mu, (0, 0), 2, out_dtype=torch.bfloat16,
                               fast_math=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        S.gaussian_shift_scale(torch.zeros(1000), torch.zeros(1000), (0, 0), 1)
