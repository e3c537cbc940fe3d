"""The bf16 stacked sampler's bracket, held on the CPU.

``csrc/sampling.cu``'s ``bf16_stacked_kernel`` draws most of its noise
approximately: each value z of a pair is replaced by z' with |z' - z| <= E,
and an element keeps bf16(fl(mu + fl(sigma z'))) only where mu + sigma
(z' -/+ E), with directed roundings on z' -/+ E, round to the same bf16
bits. Its plain twin is ``ops/sampling.py::bracket_bf16``. Held here: that
the twin's "safe" is sound for every z within E (a property test and
hand-picked ties, zeros, signs and ratios), its directed additions against
exact rationals, ``bracket_constants``' formula, and the whole algorithm
(approximate noise, bracket, exact path) against ``stacked_plain`` bit for
bit, with torch's log2 / sqrt / sin / cos standing in for the card's MUFU
approximations and constants derived from them over all 2^24 words. The
card holds the kernel itself (chip_smoke.py phases 12 and 15,
tests/test_torch_gpu.py).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodal_auv_torch.ops import sampler_times as T
from multimodal_auv_torch.ops import sampling as S

F32, BF16 = torch.float32, torch.bfloat16
ALL = 1 << 24

finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
# E's range in the property tests, as f32 values
E_MIN, E_MAX = float(np.float32(1e-9)), float(np.float32(1e-2))


def t32(*xs) -> torch.Tensor:
    return torch.tensor(xs, dtype=F32)


def exact_bits(mu, sigma, z) -> torch.Tensor:
    """bf16(fl(mu + fl(sigma z))): the kernel's exact path and the plain
    version, per element."""
    return (mu + sigma * z).to(BF16).view(torch.int16)


def zs_within(zp: torch.Tensor, e: torch.Tensor, k: int = 9
              ) -> torch.Tensor:
    """(k + 4, n) f32 values inside [z' - E, z' + E] as reals: the interval
    sampled evenly, its directed-rounded ends, and the zeros of either
    sign where the interval holds 0."""
    z64, e64 = zp.double(), e.double()
    t = torch.linspace(-1, 1, k, dtype=torch.float64)[:, None]
    inner = (z64 + t * e64).to(F32)
    # round-to-nearest can step out of the interval: step back in
    out_lo = inner.double() < z64 - e64
    out_hi = inner.double() > z64 + e64
    inner = torch.where(out_lo, torch.nextafter(inner, torch.full_like(
        inner, float("inf"))), inner)
    inner = torch.where(out_hi, torch.nextafter(inner, torch.full_like(
        inner, -float("inf"))), inner)
    lo_end = S._add_directed(zp, -e, up=False)
    hi_end = S._add_directed(zp, e, up=True)
    # RD / RU widen the interval by at most one step: the ends themselves
    # lie inside [lo_end, hi_end], the tested bracket, but may lie outside
    # the exact one; a z there is still covered by the same argument
    holds0 = (z64 - e64 <= 0) & (z64 + e64 >= 0)
    zero_p = torch.where(holds0, torch.zeros_like(zp), zp)
    zero_n = torch.where(holds0, torch.full_like(zp, -0.0), zp)
    return torch.cat([inner, lo_end[None], hi_end[None], zero_p[None],
                      zero_n[None]])


def assert_sound(mu, sigma, zp, e) -> torch.Tensor:
    """Wherever the twin says safe, every z within E gives its bits.
    Returns the safe mask."""
    lo, safe = S.bracket_bf16(mu, sigma, zp, e)
    for z in zs_within(zp, e):
        want = exact_bits(mu, sigma, z)
        bad = safe & (lo != want)
        assert not bool(bad.any()), (
            f"unsound at mu={mu[bad][:3]}, sigma={sigma[bad][:3]}, "
            f"z'={zp[bad][:3]}, E={e[bad][:3]}, z={z[bad][:3]}")
    return safe


@settings(max_examples=300, deadline=None)
@given(finite32, finite32, st.booleans())
def test_directed_add_is_exact_rounding(x, y, up):
    """``_add_directed`` rounds the exact sum to the f32 grid toward +inf or
    -inf, as __fadd_ru / __fsub_rd do."""
    a, b = t32(x), t32(y)
    got = S._add_directed(a, b, up)
    if not bool(torch.isfinite(got).all()):
        return  # overflow: the kernel never adds such values
    exact = Fraction(x) + Fraction(y)
    g = Fraction(float(got))
    # the f32 value one step back toward the exact sum lies past it
    nxt = float(torch.nextafter(got, t32(-float("inf") if up
                                         else float("inf"))))
    if up:
        assert g >= exact and (nxt == -float("inf") or Fraction(nxt) < exact)
    else:
        assert g <= exact and (nxt == float("inf") or Fraction(nxt) > exact)


def test_directed_add_signs_of_zero():
    """An exact zero is -0 rounding down unless both terms are +0, and +0
    rounding up unless both are -0 (IEEE 754)."""
    x = t32(1.5, 0.0, -0.0, 0.0, -0.0)
    y = t32(-1.5, 0.0, -0.0, -0.0, 0.0)
    down = S._add_directed(x, y, up=False)
    upw = S._add_directed(x, y, up=True)
    assert torch.signbit(down).tolist() == [True, False, True, True, True]
    assert torch.signbit(upw).tolist() == [False, False, True, False, False]


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2 ** 32 - 1))
def test_bracket_safe_is_sound(seed):
    """A batch drawn from a seed: weight-sized and large mu, sigma of
    either sign from 0 to 10 |mu|, z' in the noise's range, E from 1e-9 to
    1e-2; every z within E gives the safe elements' bits."""
    rng = np.random.default_rng(seed)
    n = 512
    mu = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 3, n)
    ratio = 10.0 ** rng.uniform(-6, 1, n) * rng.choice([-1, 1, 1, 1], n)
    sigma = mu * ratio * rng.choice([0, 1], n, p=[0.05, 0.95])
    zp = rng.uniform(-6, 6, n)
    e = 10.0 ** rng.uniform(-9, -2, n)
    args = [torch.from_numpy(a).to(F32) for a in (mu, sigma, zp, e)]
    assert_sound(*args)


@settings(max_examples=300, deadline=None)
@given(finite32, finite32,
       st.floats(-6, 6, width=32),
       st.floats(E_MIN, E_MAX, width=32))
def test_bracket_safe_is_sound_single(mu, sigma, zp, e):
    """The same property on hypothesis' own floats (subnormal, huge, ±0)."""
    with np.errstate(over="ignore"):
        top = np.float32(abs(mu)) + np.float32(abs(sigma)) * np.float32(6.1)
    if not np.isfinite(top):
        return  # mu + sigma z overflows: no posterior does that
    assert_sound(t32(mu), t32(sigma), t32(zp), t32(e))


def test_bracket_hand_picked():
    """bf16 ties, signed zeros, sigma = 0 and -0, negative sigma and large
    |mu| / sigma: sound everywhere; an output on a tie whose bracket holds
    it is never decided by the fast path, one deep inside a bf16 value
    always is."""
    base = torch.tensor([0.375, -1.25, 3.0e-3, 7.0], dtype=F32)
    tie = ((base.view(torch.int32) & ~0xFFFF) | 0x8000).view(F32)
    cases = []
    # mu exactly on a bf16 tie, z' within E of 0, sigma E many f32 steps of
    # mu: the bracket holds the tie
    for s in (1.0, -1.0):
        cases.append((tie, s * tie.abs(), t32(1e-7, -2e-7, 0.0, -0.0),
                      t32(*[3e-6] * 4)))
    # ... and z' away from 0: the tie is outside the bracket
    cases.append((tie, 1e-3 * tie.abs(), t32(0.7, -0.3, 2.0, -4.0),
                  t32(*[3e-6] * 4)))
    # sigma = +0 and -0, mu nonzero and +-0, z' on either side of 0 and
    # within E of it
    mus = t32(0.0, -0.0, 0.0, -0.0, 1.0, -2.0, 0.0, -0.0)
    zps = t32(1e-7, 1e-7, -1e-7, -1e-7, 0.5, -0.5, 2e-6, 2e-6)
    es = t32(*[2e-6] * 8)
    for s in (0.0, -0.0, 1e-3, -1e-3):
        cases.append((mus, torch.full_like(mus, s), zps, es))
    # z' = E exactly: RD(z' - E) is -0
    cases.append((t32(-0.0, 0.0, -0.0), t32(1.0, 1.0, -1.0),
                  t32(1e-6, 1e-6, 1e-6), t32(1e-6, 1e-6, 1e-6)))
    # large |mu| / sigma: the bracket lies deep inside one bf16 value
    far = t32(1.0 + 2 ** -9, -3.0 - 2 ** -8, 100.0 + 2 ** -2)
    cases.append((far, 1e-6 * far.abs(), t32(5.0, -5.0, 1.0),
                  t32(1e-5, 1e-5, 1e-5)))
    safes = [assert_sound(*c) for c in cases]
    assert not bool(safes[0].any()) and not bool(safes[1].any())
    assert bool(safes[2].all()) and bool(safes[-1].all())
    # sigma = +-0 with mu nonzero: mu's own bits, always decided
    assert bool(safes[3][4:6].all()) and bool(safes[4][4:6].all())


def test_bracket_bucket_is_bit_length():
    w = torch.tensor([0xFFFFFF, 0xFFFFFE, 0xFFFFFD, 0xFFFFFC, 0x800000,
                      0x7FFFFF, 0, 0x1FFFFFF, 0xFF000000])
    g = [0xFFFFFF - (int(x) & 0xFFFFFF) for x in w]
    assert S.bracket_bucket(w).tolist() == [x.bit_length() for x in g]


def test_bracket_constants_formula():
    """Per-bucket maxima of the radius deviations, the largest sin / cos
    deviation, the rounding terms, the margin and the floor."""
    dev_r = torch.tensor([1e-3, 5e-4, 2e-6, 3e-6, 0.0], dtype=torch.float64)
    buckets = torch.tensor([1, 1, 24, 24, 0])
    dev_sc = torch.tensor([1e-7, 4e-7, 2e-7], dtype=torch.float64)
    e_r, e_sc = S.bracket_constants(dev_r, buckets, dev_sc, 1.0, margin=2.0)
    k = (1.0 + 4e-7 + 2.0 ** -24) * 2.0
    assert len(e_r) == S.BRACKET_SLOTS
    assert e_r[1] == pytest.approx(1e-3 * k, rel=1e-12)
    assert e_r[24] == pytest.approx(3e-6 * k, rel=1e-12)
    assert e_r[0] == S.BRACKET_FLOOR and e_r[5] == S.BRACKET_FLOOR
    assert e_sc == pytest.approx((4e-7 + 2.0 ** -23) * 2.0, rel=1e-12)


@pytest.fixture(scope="module")
def cpu_bracket():
    """The contract's parts and torch's approximations of them over all
    2^24 words, and the bracket constants they need (margin 1.5)."""
    exact = S.noise_parts_plain(ALL, "f32")
    approx = S.approx_parts_plain(ALL)
    dev_r, dev_sc, c_max = S.bracket_deviations(exact, approx)
    e_r, e_sc = S.bracket_constants(
        dev_r, S.bracket_bucket(torch.arange(ALL)), dev_sc, c_max, 1.5)
    return exact, approx, torch.tensor(e_r, dtype=F32), float(e_sc)


def _e_of(r_approx: torch.Tensor, b1: torch.Tensor, e_r, e_sc
          ) -> torch.Tensor:
    """E = fma(r', E_sc, E_r[bucket]) rounded once to f32, as the kernel."""
    return (r_approx.double() * float(np.float32(e_sc))
            + e_r[S.bracket_bucket(b1)].double()).to(F32)


def test_bracket_constants_bound_the_pair_values(cpu_bracket):
    """|fl(r' c') - fl(r c)| <= E for pairs of words, the g = 0, 1, 2 and
    r-largest words among them: the formula covers the products'
    roundings."""
    (r, s, c), (ra, sa, ca), e_r, e_sc = cpu_bracket
    g = torch.Generator().manual_seed(3)
    w1 = torch.cat([torch.tensor([0xFFFFFF, 0xFFFFFE, 0xFFFFFD, 0, 1]),
                    torch.randint(0, ALL, (1 << 18,), generator=g)])
    w2 = torch.randint(0, ALL, (w1.numel(),), generator=g)
    e = _e_of(ra[w1], w1, e_r, e_sc)
    for t, ta in ((c, ca), (s, sa)):
        z = r[w1] * t[w2]
        zp = ra[w1] * ta[w2]
        assert bool(((zp.double() - z.double()).abs() <= e.double()).all())


def _model_draw(mu, sigma, b1, b2, P, e_r, e_sc):
    """One draw of the kernel's algorithm with torch's approximations:
    (bits of the fast path, safe mask, exact bits) per element."""
    f1 = ((b1 & 0xFFFFFF) + 1).double()
    ra = torch.sqrt(torch.clamp_min((24.0 - torch.log2(f1))
                                    * (2 * S._LN2), 0)).to(F32)
    d = ((b2 & 0xFFFFFF).double() / 16777216.0 - 0.5) * (2 * S._PI)
    sin_t, cos_t = (-torch.sin(d)).to(F32), (-torch.cos(d)).to(F32)
    zp = S.block_layout(ra * cos_t, ra * sin_t, P)
    e_pair = _e_of(ra, b1, e_r, e_sc)
    e = S.block_layout(e_pair, e_pair, P)
    fast, safe = S.bracket_bf16(mu.float(), sigma.float(), zp, e)
    z = S.block_noise(b1, b2, P)
    return fast, safe, exact_bits(mu.float(), sigma.float(), z)


@pytest.mark.parametrize("P", [65536 + 128, 65536 + 16384 + 256,
                               65536 + 32768 + 384, 65536 + 49152 + 512])
def test_kernel_algorithm_equals_stacked_plain(cpu_bracket, P):
    """The kernel's algorithm on the CPU, at P's whose last block ends in
    each quarter, two draws: the fast path's bits equal ``stacked_plain``'s
    wherever the bracket decides, on a MOPED-like posterior (bf16 in),
    sigma = |mu| (bf16 and f32 in) and f32 mu placed on bf16 ties for draw
    0 (``sampler_times.tie_posterior``); the exact path is taken on each,
    on nearly every element of the ties' draw 0."""
    _, _, e_r, e_sc = cpu_bracket
    rng = np.random.default_rng(P)
    mu32 = torch.from_numpy(rng.standard_normal(P) * 0.05).to(F32)
    mu16 = mu32.to(BF16)
    seed = (P, 0xFFFFFFF0)
    posts = {"moped bf16": (mu16, (0.1 * mu16.float().abs()).to(BF16)),
             "sigma=|mu| bf16": (mu16, mu16.abs()),
             "sigma=|mu| f32": (mu32, mu32.abs()),
             "f32 ties": T.tie_posterior(mu32, seed)}
    shares = {}
    for name, (mu, sg) in posts.items():
        want = S.stacked_plain(mu, sg, seed, 2, BF16).view(torch.int16)
        for d in range(2):
            b1, b2 = S.noise_bits(P, seed, d)
            fast, safe, exact = _model_draw(mu, sg, b1, b2, P, e_r, e_sc)
            assert torch.equal(exact, want[d])
            assert torch.equal(fast[safe], want[d][safe]), name
            shares[name, d] = float((~safe).double().mean())
    assert 0 < shares["moped bf16", 0] + shares["moped bf16", 1] < 0.01
    assert shares["sigma=|mu| bf16", 0] > shares["moped bf16", 0]
    assert shares["f32 ties", 0] > 0.9 and shares["f32 ties", 1] < 0.1


def test_approx_parts_on_the_cpu_and_the_counter_refusal():
    """``approx_parts`` on the CPU is its plain version, within the
    contract's own error of the f32 parts; the exact-path counter is a
    measurement of the card's kernel and refuses CPU tensors."""
    n = 1 << 12
    got = S.approx_parts(n, "cpu")
    for a, b in zip(got, S.approx_parts_plain(n)):
        assert torch.equal(a, b)
    dev_r, dev_sc, c_max = S.bracket_deviations(
        S.noise_parts_plain(n, "f32"), got)
    assert float(dev_r.max()) < 2e-3 and float(dev_sc.max()) < 1e-6
    assert c_max == 1.0
    mu = torch.zeros(S.LANES)
    with pytest.raises(ValueError, match="card"):
        S.stacked_exact_calls(mu, mu, (1, 2), 1)
