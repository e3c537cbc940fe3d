"""The port's RNG-split probe (``multimodal_auv_torch/ops/probe_rng_split.py``)
against ``scripts/probe_rng_split.py``.

The script is loaded by path, unedited. Its polynomials are held against
the port's plain versions on the same numpy f32 inputs, and its kernels
``_bits_kernel`` and ``_bmlite_kernel`` run on the CPU as the JAX package
runs its own there: a ``pl.pallas_call`` with the script's BlockSpecs and
``interpret=pltpu.InterpretParams()``, which stubs the random bits to zero.
Those zero-bit outputs are held against the port's plain versions on zero
bits, laid out the same way. The CUDA kernels are held bit for bit against
the plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import probe_rng_split as PR
from multimodal_auv_torch.ops import sampling as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAGGED_P = 512 * 128 + 1024  # one full block and a partial one


@pytest.fixture(scope="module")
def script():
    """scripts/probe_rng_split.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "probe_rng_split_script",
        os.path.join(REPO, "scripts", "probe_rng_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _uniform_words(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, (1 << 23) - 1, 1 << 23, (1 << 24) - 2,
                      (1 << 24) - 1, 1 << 22, 3 << 22], np.int64)
    return np.concatenate([edges, rng.integers(0, 1 << 24, n)])


def test_lite_ln_matches_script(script):
    """The 2-term ln series on the kernel's domain [1, 2^24]: rtol 1e-6
    (XLA:CPU may contract the multiply-adds into FMAs)."""
    f = (_uniform_words() + 1).astype(np.float32)
    want = np.asarray(script._fast_ln_lite(jnp.asarray(f)))
    got = S.fast_ln(torch.from_numpy(f), "lite").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_lite_sincos_matches_script(script):
    """``_fast_sincos_2pi_lite`` is the port's trimmed sin/cos, on u in
    [0, 1) with the quadrant edges: rtol 1e-6 with an atol of one f32 ulp
    at 1 for values at 0."""
    u = (_uniform_words() * (1.0 / 16777216.0)).astype(np.float32)
    u = np.concatenate([u, np.float32([0.0, 0.125, 0.25, 0.5, 0.75])])
    js, jc = script._fast_sincos_2pi_lite(jnp.asarray(u))
    s, c = S.fast_sincos_2pi(torch.from_numpy(u), "lite")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1.2e-7)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1.2e-7)


def _interpret(script, kernel, rows, num_draws, out_dtype):
    """The script's ``_launch`` geometry, run by the TPU interpreter."""
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(rows, script.BLOCK_ROWS), num_draws),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, script.BLOCK_ROWS, script.LANES),
                               lambda i, d: (d, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((num_draws, rows, script.LANES),
                                       out_dtype),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray([12345], jnp.int32))


def _zero_bits(P):
    nblk = -(-P // S.BLOCK_ELEMS)
    return torch.zeros((nblk, S.PAIRS_PER_BLOCK), dtype=torch.int64)


def test_zero_bits_bits_kernel_matches_script(script):
    """``_bits_kernel`` in interpret mode (bits stubbed to zero) over two
    blocks and two draws, bf16 as the probe writes it: the f1 half reads 1.0
    and the f2 half 0.0, as the port's plain version on zero bits does.
    Exact: both are small integers."""
    P = 2 * S.BLOCK_ELEMS
    want = np.asarray(_interpret(script, script._bits_kernel, P // S.LANES,
                                 2, jnp.bfloat16).astype(jnp.float32))
    z = _zero_bits(P)
    got = S.block_layout(*PR.bits_pair(z, z), P).to(torch.bfloat16)
    got = got.to(torch.float32).numpy()
    assert set(np.unique(want)) == {0.0, 1.0}
    for d in range(2):
        np.testing.assert_array_equal(got, want[d].reshape(-1))


def test_zero_bits_bmlite_kernel_matches_script(script):
    """``_bmlite_kernel`` in interpret mode (bits stubbed to zero), two
    blocks, two draws, f32 as the probe's fidelity check writes it: the cos
    half reads r = sqrt(-2 ln 2^-24) (5.7681074), the sin half ~0, as the
    port's lite Box-Muller on zero bits gives. At zero bits z = 0, so this
    checks the layout and r, not the polynomials (the tests above do).
    Tolerance rtol 3e-5, atol 5e-7: the interpreter evaluates the body op by
    op on XLA:CPU, and in some runs (about one in ten under parallel test
    workers) one 64-row chunk of the cos half comes out 1.9e-5 relative off
    the value every other run gives."""
    P = 2 * S.BLOCK_ELEMS
    want = np.asarray(_interpret(script, script._bmlite_kernel, P // S.LANES,
                                 2, jnp.float32))
    z = _zero_bits(P)
    got = S.block_layout(*S.box_muller(z, z, "lite"), P).numpy()
    np.testing.assert_allclose(got[:S.PAIRS_PER_BLOCK], 5.7681074, rtol=1e-7)
    for d in range(2):
        np.testing.assert_allclose(got, want[d].reshape(-1), rtol=3e-5,
                                   atol=5e-7)


def test_plain_versions_share_the_samplers_bits():
    """On the CPU the wrappers run their plain versions and launch nothing.
    rng_bits' floats are each pair's two words: fed back through the f32
    Box-Muller they give the eps of the same seed bit for bit (f1 < 2^24 + 1
    and f2 < 2^24 are exact in f32); eps_fast is the split sampler's fast
    noise at (0, 1); lite is within its polynomials' error of the f32
    noise on the same bits; the probe's ``bm`` is the eps at bf16."""
    seed, n = (31, 4), 2
    before = dict(kernels.LAUNCHES)
    bits = PR.rng_bits(RAGGED_P, seed, n, "cpu", torch.float32)
    eps = S.gaussian_noise(RAGGED_P, seed, n, "cpu")
    lite = PR.rng_bmlite(RAGGED_P, seed, n, "cpu", torch.float32)
    fast = PR.eps_fast(RAGGED_P, seed, n, "cpu")
    assert kernels.LAUNCHES == before
    assert bits.dtype == eps.dtype == lite.dtype == torch.float32
    assert fast.dtype == torch.bfloat16
    # the feedback needs both words of every pair: whole blocks only
    whole = (RAGGED_P // S.BLOCK_ELEMS) * S.BLOCK_ELEMS
    for d in range(n):
        f = bits[d, :whole].reshape(-1, 2, S.PAIRS_PER_BLOCK).to(torch.int64)
        b1, b2 = f[:, 0] - 1, f[:, 1]
        assert int(b1.min()) >= 0 and int(b1.max()) < 1 << 24
        assert int(b2.min()) >= 0 and int(b2.max()) < 1 << 24
        assert torch.equal(S.block_noise(b1, b2, whole), eps[d, :whole])
    zeros, ones = torch.zeros(RAGGED_P), torch.ones(RAGGED_P)
    split = S.gaussian_shift_scale_split(zeros.bfloat16(), ones.bfloat16(),
                                         seed, n, fast_math=True)
    assert all(torch.equal(a, b) for a, b in zip(split, fast))
    # the 2-term series truncates ln by at most 2 (1/3)^5 / 5 = 1.65e-3;
    # where ln u1 ~ 0 that moves r = sqrt(-2 ln u1) by up to
    # sqrt(2 * 1.65e-3) = 0.0574, and the trimmed sin/cos adds <= 3.3e-4 r
    d = (lite - eps).abs()
    assert float(d.max()) < 0.0574 + 3.3e-4 * 6 and float(d.mean()) < 1e-3
    assert torch.equal(PR.bm(RAGGED_P, seed, n, "cpu"), eps.bfloat16())


def test_probe_refuses_without_card_and_bad_args():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.run(P=RAGGED_P, num_draws=2)
    with pytest.raises(ValueError, match="bf16-output-only"):
        PR.eps_fast(RAGGED_P, (0, 0), 1, "cpu", torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        PR.rng_bits(1000, (0, 0), 1, "cpu")
    assert PR.PROBE_P == 72_941_568 and PR.PROBE_P % S.BLOCK_ELEMS == 0
    assert PR.launches_of_run(10) == {"rng_bits": 22, "eps": 23,
                                      "rng_bmlite": 23, "eps_fast": 22}
