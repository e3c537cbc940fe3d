"""The port's split posterior sampler against the JAX package's.

The TPU's random bits cannot be reproduced, so the sampler is held to the
JAX package four ways: the four fast-math polynomials on the same inputs,
Box-Muller from zero bits against the JAX kernel in interpret mode (which
stubs its random bits to zero), the port's own seeding contract, and
moments. The CUDA kernel itself is held bit for bit against the plain
version on the card, in tests/test_torch_gpu.py.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import sampling as S
from multimodal_auv_tpu.ops import sampling as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAGGED_P = 512 * 128 + 1024  # one full block and a partial one


def _edges_and_random(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, (1 << 23) - 1, 1 << 23, (1 << 24) - 2,
                      (1 << 24) - 1, 1 << 22, 3 << 22, 1 << 21], np.int64)
    return np.concatenate([edges, rng.integers(0, 1 << 24, n)])


@pytest.mark.parametrize("noise", ["f32", "fast"], ids=["f32", "bf16"])
def test_fast_ln_matches_jax(noise):
    # f = 24-bit uniform + 1, the kernel's whole input domain [1, 2^24]
    f = (_edges_and_random() + 1).astype(np.float32)
    jfn = J._fast_ln_bf16 if noise == "fast" else J._fast_ln
    want = np.asarray(jfn(jnp.asarray(f)))
    got = S.fast_ln(torch.from_numpy(f), noise).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("noise", ["f32", "fast"], ids=["f32", "bf16"])
def test_fast_sincos_matches_jax(noise):
    # u = 24-bit uniform / 2^24 in [0, 1), quadrant edges included
    u = (_edges_and_random() * (1.0 / 16777216.0)).astype(np.float32)
    u = np.concatenate([u, np.float32([0.0, 0.125, 0.25, 0.5, 0.75])])
    jfn = J._fast_sincos_2pi_bf16 if noise == "fast" else J._fast_sincos_2pi
    js, jc = jfn(jnp.asarray(u))
    s, c = S.fast_sincos_2pi(torch.from_numpy(u), noise)
    # rtol 1e-6 in f32, with an atol of one f32 ulp at 1 for values at 0
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1.2e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1.2e-7)


def test_philox_known_answers():
    """Philox-4x32-10 known-answer vectors of the Random123 reference."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        out = S.philox4x32_10([torch.tensor([c]) for c in ctr], key[0],
                              torch.tensor([key[1]]))
        assert tuple(int(o) for o in out) == want


def test_noise_bits_follow_the_contract():
    """``noise_bits`` word for word: in stream (draw, blk), keyed (seed0,
    seed1 + draw * nblk + blk) mod 2^32, pair j's bits are words (x0, x1)
    of ``philox4x32_10`` at counter (j, 0, 0, 0), and pair j + 16384's are
    words (x2, x3) of the same call."""
    P = 2 * S.BLOCK_ELEMS + 128
    nblk, calls = 3, S.CALLS_PER_BLOCK
    seed = (0x9E3779B9, 0xFFFFFFFE)  # the key wraps mod 2^32
    for draw in (0, 2):
        b1, b2 = S.noise_bits(P, seed, draw)
        assert b1.shape == b2.shape == (nblk, 2 * calls)
        for blk in range(nblk):
            j = torch.arange(calls)
            zero = torch.zeros((), dtype=torch.int64)
            key1 = (seed[1] + draw * nblk + blk) % (1 << 32)
            x = S.philox4x32_10((j, zero, zero, zero), seed[0], key1)
            assert torch.equal(b1[blk, :calls], x[0])
            assert torch.equal(b2[blk, :calls], x[1])
            assert torch.equal(b1[blk, calls:], x[2])
            assert torch.equal(b2[blk, calls:], x[3])


def test_smoke_counts_the_contracts_philox_calls():
    """chip_smoke.py's Philox estimate counts one call per call index j
    whose element j lies inside P: a block's 16384 calls, fewer in a last
    block that ends inside its first quarter, all of them once it reaches
    the second."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    calls = S.CALLS_PER_BLOCK
    assert smoke.philox_calls(2 * S.BLOCK_ELEMS + 128, 3) == 3 * (2 * calls
                                                                + 128)
    assert smoke.philox_calls(S.BLOCK_ELEMS + 16384 + 256, 1) == 2 * calls
    assert smoke.philox_calls(S.BLOCK_ELEMS, 2) == 2 * calls


def test_noise_modes():
    """One mode names each set of polynomials, as the CUDA source's
    ``Noise`` does; an unknown mode raises instead of falling back."""
    f = torch.tensor([1.5, 1000.0, 16777216.0])
    ln = {m: S.fast_ln(f, m) for m in S.NOISE_MODES}
    assert not torch.equal(ln["f32"], ln["fast"])
    assert not torch.equal(ln["fast"], ln["lite"])
    u = torch.tensor([0.1, 0.3, 0.7])
    assert torch.equal(torch.stack(S.fast_sincos_2pi(u, "fast")),
                       torch.stack(S.fast_sincos_2pi(u, "lite")))
    for fn, x in ((S.fast_ln, f), (S.fast_sincos_2pi, u)):
        with pytest.raises(ValueError, match="noise 'bf16'"):
            fn(x, "bf16")


@pytest.mark.parametrize("fast_math", [False, True], ids=["f32", "bf16fast"])
def test_zero_bits_match_jax_interpret(fast_math):
    """Zero random bits in the port's Box-Muller and block layout equal
    the JAX split kernel in interpret mode (its bits are stubbed to zero),
    at a P whose last block is partial. Tolerance: in f32, XLA:CPU may
    contract mu + sigma * eps into one FMA where the port rounds twice, so
    the two agree to one rounding of |w| < 4: atol 5e-7 (2 ulp at 4) with
    rtol 1e-6. In bf16 that FMA can move an f32 value off an exact
    rounding tie, so bf16 outputs agree to one bf16 ulp (rtol 2^-7)."""
    dt_j = jnp.bfloat16 if fast_math else jnp.float32
    dt_t = torch.bfloat16 if fast_math else torch.float32
    rng = np.random.default_rng(1)
    mu = rng.standard_normal(RAGGED_P).astype(np.float32)
    sg = rng.uniform(0.01, 0.5, RAGGED_P).astype(np.float32)
    mu_j, sg_j = jnp.asarray(mu).astype(dt_j), jnp.asarray(sg).astype(dt_j)
    outs = J.gaussian_shift_scale_split(
        mu_j, sg_j, jax.random.PRNGKey(0), 2, impl="pallas_interpret",
        out_dtype=dt_j, fast_math=fast_math)
    nblk = -(-RAGGED_P // S.BLOCK_ELEMS)
    zero = torch.zeros((nblk, S.PAIRS_PER_BLOCK), dtype=torch.int64)
    eps = S.block_noise(zero, zero, RAGGED_P, "fast" if fast_math else "f32")
    mu_t = torch.from_numpy(np.array(mu_j.astype(jnp.float32)))
    sg_t = torch.from_numpy(np.array(sg_j.astype(jnp.float32)))
    got = (mu_t + sg_t * eps).to(dt_t).to(torch.float32).numpy()
    for o in outs:
        want = np.asarray(o.astype(jnp.float32))
        if fast_math:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=5e-7)


def test_fast_math_is_bf16_only():
    mu = torch.zeros(1024)
    with pytest.raises(ValueError, match="bf16-output-only"):
        S.gaussian_shift_scale_split(mu, mu, (0, 0), 2,
                                     out_dtype=torch.float32, fast_math=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        S.gaussian_shift_scale_split(torch.zeros(1000), torch.zeros(1000),
                                     (0, 0), 1)


def test_seeding_contract_and_determinism():
    mu = torch.zeros(RAGGED_P)
    sg = torch.ones(RAGGED_P)
    launches = kernels.LAUNCHES["split_sampler"]
    a = S.gaussian_shift_scale_split(mu, sg, (7, 11), 3)
    b = S.gaussian_shift_scale_split(mu, sg, (7, 11), 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = S.gaussian_shift_scale_split(mu, sg, (7, 12), 3)
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])
    # stream (draw d, block k) is keyed seed1 + d * nblk + k: draw 1 of
    # seed (7, 11) is draw 0 of seed (7, 11 + nblk)
    nblk = -(-RAGGED_P // S.BLOCK_ELEMS)
    d = S.gaussian_shift_scale_split(mu, sg, (7, 11 + nblk), 1)
    assert torch.equal(a[1], d[0])
    # the key wraps mod 2^32 as the kernel's uint32 arithmetic does
    e = S.gaussian_shift_scale_split(mu, sg, (7, 11 + (1 << 32)), 1)
    assert torch.equal(a[0], e[0])
    # the CPU path is the plain version and launches nothing
    assert kernels.LAUNCHES["split_sampler"] == launches


@pytest.mark.parametrize("fast_math", [False, True], ids=["f32", "bf16fast"])
def test_moments_cpu(fast_math):
    """At P = 2^20: mean and std per draw, draws and blocks uncorrelated,
    and the quarters of a block too (pair j against pair j + 16384: two
    words of one Philox call). Bounds are ~5 standard errors at this P."""
    P = 1 << 20
    dt = torch.bfloat16 if fast_math else torch.float32
    mu = torch.full((P,), 0.5).to(dt)
    sg = torch.full((P,), 2.0).to(dt)
    ws = S.gaussian_shift_scale_split(mu, sg, (123, 456), 2, out_dtype=dt,
                                      fast_math=fast_math)
    eps = [(w.to(torch.float64) - 0.5) / 2.0 for w in ws]
    se = 1.0 / P ** 0.5
    for e in eps:
        assert abs(float(e.mean())) < 5 * se
        assert abs(float(e.std()) - 1.0) < 5 * se * 2 ** 0.5 + 2e-3 * fast_math
        inside = float((e.abs() < 1.0).to(torch.float64).mean())
        assert abs(inside - 0.6826894921) < 5 * 0.466 * se + 2e-3 * fast_math
    corr = lambda x, y: float(torch.corrcoef(torch.stack([x, y]))[0, 1])
    assert abs(corr(eps[0], eps[1])) < 5 * se
    blk = S.BLOCK_ELEMS
    half = S.PAIRS_PER_BLOCK
    # neighbouring blocks, and the cos and sin halves of one block
    assert abs(corr(eps[0][:blk], eps[0][blk:2 * blk])) < 5 / blk ** 0.5
    assert abs(corr(eps[0][:half], eps[0][half:blk])) < 5 / half ** 0.5
    # quarter q of every block: element j + q * 16384 for j < 16384; pairs
    # j and j + 16384 hold quarters (0, 2) and (1, 3)
    quarters = eps[0].reshape(-1, 4, S.CALLS_PER_BLOCK)
    n_q = quarters[:, 0].numel()
    for a, b in ((0, 1), (2, 3), (0, 3), (1, 2)):
        assert abs(corr(quarters[:, a].reshape(-1),
                        quarters[:, b].reshape(-1))) < 5 / n_q ** 0.5
