"""The exact forms of the noise kernels' Box-Muller, held bit for bit against
the plain conversions they replace, over every input the noise meets.

``csrc/sampling.cu`` (``exponent_of``, ``radius``, ``angle``) computes parts
of Box-Muller in other operations than the plain versions of
``ops/sampling.py`` (``fast_ln``, ``fast_sincos_2pi``, ``box_muller``),
operations chosen so that every result keeps its bits. Each form is
mirrored here in torch f32 (an fma whose product is exact is an add of that
product; an add rounded down is the exact f64 sum rounded down to the f32
grid) and held against the plain version over all 2^24 words of b1 or b2,
bits compared (-0 apart from +0). The MUFU-based division and square root
have no CPU mirror: the card holds them, with everything else, through
``noise_parts`` over the same 2^24 words (chip_smoke.py, phase 12).
"""
import numpy as np
import pytest
import torch

from multimodal_auv_torch.ops import sampling as S

ALL = 1 << 24
M24 = 0xFFFFFF
F32 = torch.float32


def f32(x: float) -> torch.Tensor:
    """A Python double rounded to f32, as the kernels' constants are."""
    return torch.tensor(x, dtype=F32)


K_LN2 = f32(0.6931471805599453)
K_24LN2 = f32(24.0 * 0.6931471805599453)
K_TWO_PI = f32(6.283185307179586)
K_TWO_OVER_PI = f32(2.0 / 3.141592653589793)
K_PI_OVER_TWO = f32(3.141592653589793 / 2.0)
MAGIC_Q = 12582912.0  # 1.5 * 2^23


def as_f32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 patterns held in int64 -> f32 with those bits."""
    return (((bits & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(
        torch.int32).view(F32)


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its bits as uint32 values in int64."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype == F32 and got.shape == want.shape
    bad = bits_of(got) != bits_of(want)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} differ, first at "
        f"{int(bad.nonzero()[0])}: {got[bad][:4]} vs {want[bad][:4]}")


@pytest.fixture(scope="module")
def words() -> torch.Tensor:
    return torch.arange(ALL, dtype=torch.int64)


@pytest.fixture(scope="module")
def f1(words) -> torch.Tensor:
    """The plain f1 = (b1 & 0xFFFFFF) + 1 of every word, [1, 2^24]."""
    return ((words & M24) + 1).to(F32)


def test_exponent_magic_all_f1(f1):
    """``exponent_of``: (float)((i >> 23) - 127) of f1's bits i is
    as_float((i >> 23) + 0x4B000000) - (2^23 + 127), for every f1."""
    i = bits_of(f1)
    want = ((f1.view(torch.int32) >> 23) - 127).to(F32)
    got = as_f32((i >> 23) + 0x4B000000) - f32(8388735.0)
    assert_same_bits(got, want)
    assert float(want.min()) == 0.0 and float(want.max()) == 24.0


def _poly_ln(z2: torch.Tensor, noise: str) -> torch.Tensor:
    """``fast_ln``'s series in z2, per noise mode (the kernel's too)."""
    if noise == "lite":
        return 1.0 + z2 * (1.0 / 3.0)
    if noise == "fast":
        return 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0))
    return 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (
        1.0 / 7.0 + z2 * (1.0 / 9.0))))


@pytest.mark.parametrize("noise", S.NOISE_MODES)
def test_radius_argument_rearranged_all_f1(f1, noise):
    """``radius``: the square root's argument -2 (ln f1 - 24 ln 2) of the
    plain version, as -(fma(4, z p, e (2 ln 2)) - 2 (24 ln 2)): the fma's
    product 4 z p is exact, and every scaling by a power of two commutes
    with rounding here. Equal bits for every f1, the -0 at f1 = 2^24
    (u1 = 1) included."""
    want = -2.0 * (S.fast_ln(f1, noise) - 24.0 * 0.6931471805599453)
    i = f1.view(torch.int32)
    m = ((i & 0x7FFFFF) | 0x3F800000).view(F32)
    z = (m - 1.0) / (m + 1.0)
    zp = z * _poly_ln(z * z, noise)
    e = as_f32((bits_of(f1) >> 23) + 0x4B000000) - f32(8388735.0)
    four_zp = 4.0 * zp
    assert torch.equal(four_zp.double(), 4.0 * zp.double())
    two_ln = e * (2.0 * K_LN2) + four_zp
    got = -(two_ln - 2.0 * K_24LN2)
    assert_same_bits(got, want)
    last = want[-1:]
    assert float(last) == 0.0 and bool(torch.signbit(last))
    assert_same_bits(torch.sqrt(got), torch.sqrt(want))


def _u2_minus_half_plain(words: torch.Tensor) -> torch.Tensor:
    return (words & M24).to(F32) * (1.0 / 16777216.0) - 0.5


def _u2_minus_half_magic(words: torch.Tensor) -> torch.Tensor:
    """``angle``'s u2 - 0.5 from the word's bits: 0.5 + (b mod 2^23) / 2^24,
    less 0.5 when bit 23 is set, else less 1.0."""
    v = as_f32((words & 0x7FFFFF) | 0x3F000000)
    c = as_f32((words & 0x800000) ^ 0x3F800000)
    return v - c


def test_u2_minus_half_magic_all_words(words):
    want = _u2_minus_half_plain(words)
    assert_same_bits(_u2_minus_half_magic(words), want)
    # the plain form's two roundings are exact as well
    b = (words & M24).double()
    assert torch.equal(want.double(), b / 16777216.0 - 0.5)


def _add_round_down(t: torch.Tensor, c: float) -> torch.Tensor:
    """__fadd_rd(t, c): the exact sum (exact in f64 here) rounded down to
    the f32 grid."""
    exact = t.double() + c
    near = exact.to(F32)
    down = torch.nextafter(near, torch.tensor(-float("inf"), dtype=F32))
    return torch.where(near.double() > exact, down, near)


def test_quadrant_rounded_add_all_words(words):
    """floor(t) for t = x 2/pi + 0.5 in [-1.5, 2.5) is the add of 1.5 x 2^23
    rounded down, less 1.5 x 2^23; the low two bits of that sum's bits are
    floor(t) & 3; q pi/2 is exact, so x - q pi/2 is one fma."""
    x = _u2_minus_half_plain(words) * K_TWO_PI
    t = x * K_TWO_OVER_PI + 0.5
    want_q = torch.floor(t)
    sq = _add_round_down(t, MAGIC_Q)
    assert_same_bits(sq - MAGIC_Q, want_q)
    assert torch.equal(bits_of(sq) & 3,
                       want_q.to(torch.int64) & 3)
    assert set(want_q.unique().tolist()) == {-2.0, -1.0, 0.0, 1.0, 2.0}
    qc = want_q * K_PI_OVER_TWO
    assert torch.equal(qc.double(), want_q.double() * K_PI_OVER_TWO.double())
    assert_same_bits(x + (-want_q * K_PI_OVER_TWO), x - want_q * K_PI_OVER_TWO)


def _sincos_poly(y: torch.Tensor, noise: str):
    y2 = y * y
    if noise != "f32":
        s = y * (1.0 + y2 * (-1.0 / 6.0 + y2 * (1.0 / 120.0)))
        c = 1.0 + y2 * (-0.5 + y2 * (1.0 / 24.0))
    else:
        s = y * (1.0 + y2 * (-1.0 / 6.0 + y2 * (1.0 / 120.0 + y2 * (
            -1.0 / 5040.0))))
        c = 1.0 + y2 * (-0.5 + y2 * (1.0 / 24.0 + y2 * (-1.0 / 720.0 + y2 * (
            1.0 / 40320.0))))
    return s, c


@pytest.mark.parametrize("noise", S.NOISE_MODES)
def test_angle_selection_all_words(words, noise):
    """``angle`` as a whole: the magic u2 - 0.5, the rounded-down add, the
    fma, and the quadrant as one select and two sign-bit xors (-sin_x flips
    A = (k odd ? c : s) when bit 1 of k is 0; -cos_x flips B = (k odd ? s :
    c) when bit 1 of 3k is 0), against ``fast_sincos_2pi`` for every b2."""
    want_sin, want_cos = S.fast_sincos_2pi(
        (words & M24).to(F32) * (1.0 / 16777216.0), noise)
    x = _u2_minus_half_magic(words) * K_TWO_PI
    sq = _add_round_down(x * K_TWO_OVER_PI + 0.5, MAGIC_Q)
    y = x + (-(sq - MAGIC_Q) * K_PI_OVER_TWO)
    s, c = _sincos_poly(y, noise)
    k = bits_of(sq)
    odd = (k & 1).bool()
    a = bits_of(torch.where(odd, c, s))
    b = bits_of(torch.where(odd, s, c))
    got_sin = as_f32(a ^ (~(k << 30) & 0x80000000))
    got_cos = as_f32(b ^ (~((k * 0xC0000000) & 0xFFFFFFFF) & 0x80000000))
    assert_same_bits(got_sin, want_sin)
    assert_same_bits(got_cos, want_cos)


def _bf16_rne_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even of finite f32 to bf16 in integer operations:
    (i + 0x7FFF + ((i >> 16) & 1)) >> 16."""
    i = bits_of(x)
    return (((i + 0x7FFF + ((i >> 16) & 1)) >> 16) & 0xFFFF)


def _bf16_cast_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def test_bf16_rounding_ties_and_neighbours():
    """The plain versions' f32 -> bf16 cast, which the kernels' packed
    conversion (F2FP.BF16.F32.PACK_AB, round to nearest even) meets on the
    card, is round-to-nearest-even at every tie in [-8, 8] (low 16 bits
    0x8000) and at both neighbours of each tie."""
    hi = torch.arange(1 << 16, dtype=torch.int64) << 16
    ties = as_f32(hi | 0x8000)
    ties = ties[torch.isfinite(ties) & (ties.abs() <= 8.0)]
    assert ties.numel() > 30000
    t = bits_of(ties)
    for x in (ties, as_f32(t - 1), as_f32(t + 1)):
        assert torch.equal(_bf16_cast_bits(x), _bf16_rne_bits(x))


def test_bf16_rounding_random_sample():
    """10^7 random f32 in [-8, 8], half uniform in value and half uniform
    in bit pattern: the cast is round-to-nearest-even."""
    rng = np.random.default_rng(11)
    n = 5_000_000
    by_value = torch.from_numpy(rng.uniform(-8.0, 8.0, n).astype(np.float32))
    pat = rng.integers(0, 0x41000000, n, dtype=np.int64)  # |x| <= 8
    pat |= rng.integers(0, 2, n, dtype=np.int64) << 31
    by_bits = as_f32(torch.from_numpy(pat))
    for x in (by_value, by_bits):
        assert bool((x.abs() <= 8.0).all())
        assert torch.equal(_bf16_cast_bits(x), _bf16_rne_bits(x))


def test_noise_parts_plain_is_box_muller():
    """The pieces that the card's check compares (``noise_parts``: on the
    CPU its plain version) multiply back into ``box_muller`` bit for bit,
    on words that are both b1 and b2."""
    n = 1 << 16
    r, s, c = S.noise_parts(n, "fast", "cpu")
    words = torch.arange(n, dtype=torch.int64)
    v_cos, v_sin = S.box_muller(words, words, "fast")
    assert_same_bits(r * c, v_cos)
    assert_same_bits(r * s, v_sin)
    with pytest.raises(ValueError):
        S.noise_parts((1 << 24) + 1, "fast", "cpu")
    with pytest.raises(ValueError):
        S.noise_parts(16, "bogus", "cpu")
