"""Posterior samplers: ``num_draws`` draws w_d = mu + sigma * eps_d.

Port of ``multimodal_auv_tpu/ops/sampling.py``:

* ``split_draws`` / ``gaussian_shift_scale_split`` (Pallas
  ``_pallas_reparam_split``): the inference sampler, a (num_draws, P)
  tensor or a list of its rows, not differentiable;
* ``gaussian_shift_scale`` (Pallas ``_reparam_sigma_kernel``): the training
  sampler, a stacked (num_draws, P) tensor, differentiable. Its backward
  regenerates eps from the seed (Pallas ``_eps_kernel``, here
  ``gaussian_noise``) instead of saving it, as ``_gss_bwd`` does;
* ``gaussian_reparam`` (Pallas ``_reparam_kernel``): w = mu +
  softplus_k(rho) * eps with the softplus taken inside the kernel, the
  sampler of ``bayes.sample_weights`` and ``ModelBundle.sample_and_apply``;
  not differentiable.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/sampling.cu``; on a CPU tensor it runs the plain PyTorch version
below, which does the same arithmetic op for op, so the two agree bit for
bit on the card. Every plain version draws its bits from the one function
``noise_bits``, the samplers' eps through ``eps_plain``.

The noise contract (the same for every kernel, so the backward
regenerates exactly the forward's eps):

* P elements form blocks of 512 x 128 = 65536; the last block may be
  partial, and nothing is written past P.
* Stream (draw, blk) is Philox-4x32-10 keyed
  (seed0, seed1 + draw * nblk + blk) mod 2^32.
* Call j in [0, 16384) of a stream uses counter (j, 0, 0, 0) and gives
  words (x0, x1, x2, x3): pair j takes (x0, x1) and pair j + 16384 takes
  (x2, x3) as its bits (b1, b2).
* Pair i in [0, 32768) of a block is the element pair (i, i + 32768).
* Box-Muller on two 24-bit uniforms, with the JAX package's fast-math ln
  and sin/cos polynomials in f32: u1 = ((b1 & 0xFFFFFF) + 1) / 2^24,
  u2 = (b2 & 0xFFFFFF) / 2^24, r = sqrt(-2 ln u1); the pair takes
  (r cos 2 pi u2, r sin 2 pi u2).

The stacked sampler with bf16 output keeps the contract with fewer
instructions on the card (``bracket_bf16`` below is the plain twin of its
decision): it rounds mu + sigma z' for an approximation z' of each value
and its bound E, and keeps the bf16 result where both ends of [z' - E,
z' + E] give the same bits, recomputing the rest exactly; its output
equals ``stacked_plain``'s bit for bit.

A seed is a pair of 32-bit words, the counterpart of the JAX package's
``_seed_from_key``; callers draw it from a ``torch.Generator``
(``chunk_seed_words``, ``chunk_seeds``). The split sampler takes its seed
as a (2,) int64 tensor on the device of mu and reads the words from device
memory, as the TPU kernel reads its ``seed_ref`` operand: it is the custom
op ``torch.ops.auv.split_sampler``, which ``torch.export`` traces (a fake
implementation gives the output's shape) and which dispatches by the
tensors' device, to the kernel on CUDA and to ``split_plain`` on the CPU.
The stacked sampler's forward is the op ``torch.ops.auv.stacked_sampler``
the same way (``stacked_draws``: the mc-sharded serving program draws a
shard's rows through it); the training path (``gaussian_shift_scale``)
launches the same kernel with its seed words by value.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from multimodal_auv_torch.ops import kernels

LANES = 128
BLOCK_ROWS = 512
BLOCK_ELEMS = BLOCK_ROWS * LANES
PAIRS_PER_BLOCK = BLOCK_ELEMS // 2
CALLS_PER_BLOCK = BLOCK_ELEMS // 4  # Philox calls: four words each

_M32 = 0xFFFFFFFF
_M24 = 0xFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# Python doubles as the JAX package writes them; each is rounded to f32
# where it meets an f32 tensor, as JAX's weakly typed constants are.
_LN2 = 0.6931471805599453
_TWO_PI = 6.283185307179586
_PI = 3.141592653589793

# The polynomial sets of Box-Muller, as the CUDA source's `Noise` modes
# kF32, kFast and kLite name them: the JAX package's f32 ones, its
# bf16-budget ones, and the RNG-split probe's shorter ones.
NOISE_MODES = ("f32", "fast", "lite")


def chunk_seed_words(generator: torch.Generator, nchunks: int
                     ) -> torch.Tensor:
    """One (seed0, seed1) pair of 32-bit words per chunk from
    ``generator``, as an (nchunks, 2) int64 tensor on the CPU: every
    sampling path draws its seeds here, on the host, so that no step waits
    on the device for a seed."""
    return torch.randint(0, 1 << 32, (nchunks, 2), generator=generator,
                         dtype=torch.int64)


def chunk_seeds(generator: torch.Generator, nchunks: int
                ) -> List[Tuple[int, int]]:
    """``chunk_seed_words`` as a list of (seed0, seed1) int pairs."""
    return [(int(a), int(b))
            for a, b in chunk_seed_words(generator, nchunks).tolist()]


def seed_tensor(seed: Tuple[int, int], device) -> torch.Tensor:
    """A seed pair as the (2,) int64 tensor the split sampler reads, on
    ``device``: its 32-bit words, masked as the kernels mask them."""
    return torch.tensor([int(seed[0]) & _M32, int(seed[1]) & _M32],
                        dtype=torch.int64, device=device)


def draw_offset_seed(seed: Tuple[int, int], draw0: int, P: int
              ) -> Tuple[int, int]:
    """The seed whose draw d is draw ``draw0 + d`` of ``seed``, for a
    sampler of P elements: stream (draw, blk) is keyed (seed0, seed1 +
    draw * nblk + blk), so an offset of ``draw0`` draws folds into seed1 as
    ``seed1 + draw0 * nblk`` mod 2^32. How an mc rank draws its own rows of
    a chunk with no kernel change (the backward regenerates eps from the
    same folded seed; an mc-sharded serving artifact's loader folds each
    shard's offset into the seed words it hands the program)."""
    nblk = -(-P // BLOCK_ELEMS)
    return (int(seed[0]) & _M32, (int(seed[1]) + draw0 * nblk) & _M32)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for a uint32 constant m and uint32
    values x held in int64, via 16-bit limbs so no product overflows."""
    p_lo = m * (x & 0xFFFF)          # < 2^48
    p_hi = m * (x >> 16)             # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(ctr: Sequence[torch.Tensor], k0, k1
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    words. ``k0``/``k1`` are ints or tensors broadcastable to the counter."""
    c0, c1, c2, c3 = ctr
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_noise(noise: str) -> None:
    if noise not in NOISE_MODES:
        raise ValueError(f"noise {noise!r}: one of {NOISE_MODES}")


def fast_ln(f: torch.Tensor, noise: str = "f32") -> torch.Tensor:
    """ln(f) for f32 f in [1, 2^24] via exponent bits and the atanh series
    of the mantissa: ``_fast_ln`` ("f32", 5 terms), ``_fast_ln_bf16``
    ("fast", 3 terms) or the RNG-split probe's ``_fast_ln_lite`` ("lite",
    2 terms)."""
    _check_noise(noise)
    i = f.view(torch.int32)
    e = (i >> 23) - 127
    m = ((i & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    z = (m - 1.0) / (m + 1.0)
    z2 = z * z
    if noise == "lite":
        p = 1.0 + z2 * (1.0 / 3.0)
    elif noise == "fast":
        p = 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0))
    else:
        p = 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (
            1.0 / 7.0 + z2 * (1.0 / 9.0))))
    return e.to(torch.float32) * _LN2 + 2.0 * z * p


def fast_sincos_2pi(u: torch.Tensor, noise: str = "f32"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin 2 pi u, cos 2 pi u) for f32 u in [0, 1), by quadrant reduction
    and Taylor polynomials: ``_fast_sincos_2pi`` ("f32") or
    ``_fast_sincos_2pi_bf16`` ("fast", and "lite": the probe's
    ``_fast_sincos_2pi_lite`` is the same)."""
    _check_noise(noise)
    x = (u - 0.5) * _TWO_PI
    q = torch.floor(x * (2.0 / _PI) + 0.5)
    y = x - q * (_PI / 2.0)
    y2 = y * y
    if noise != "f32":
        s = y * (1.0 + y2 * (-1.0 / 6.0 + y2 * (1.0 / 120.0)))
        c = 1.0 + y2 * (-0.5 + y2 * (1.0 / 24.0))
    else:
        s = y * (1.0 + y2 * (-1.0 / 6.0 + y2 * (1.0 / 120.0 + y2 * (
            -1.0 / 5040.0))))
        c = 1.0 + y2 * (-0.5 + y2 * (1.0 / 24.0 + y2 * (-1.0 / 720.0 + y2 * (
            1.0 / 40320.0))))
    qm = q.to(torch.int32) & 3
    sin_x = torch.where(qm == 0, s, torch.where(qm == 1, c, torch.where(
        qm == 2, -s, -c)))
    cos_x = torch.where(qm == 0, c, torch.where(qm == 1, -s, torch.where(
        qm == 2, -c, s)))
    return -sin_x, -cos_x


def box_muller(b1: torch.Tensor, b2: torch.Tensor, noise: str = "f32"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r cos t, r sin t) f32 normals from two words of random bits (int
    tensors; the low 24 bits of each are used), with the polynomials of
    ``noise`` (``NOISE_MODES``)."""
    f1 = ((b1 & _M24) + 1).to(torch.float32)
    ln_u1 = fast_ln(f1, noise) - 24.0 * _LN2
    u2 = (b2 & _M24).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * ln_u1)
    sin_t, cos_t = fast_sincos_2pi(u2, noise)
    return r * cos_t, r * sin_t


def block_layout(v_cos: torch.Tensor, v_sin: torch.Tensor, P: int
                 ) -> torch.Tensor:
    """Lay out per-pair values (nblk, 32768) as the (P,) output of one draw:
    pair i of block k fills elements k*65536 + i and k*65536 + 32768 + i."""
    return torch.stack([v_cos, v_sin], dim=1).reshape(-1)[:P]


def block_noise(b1: torch.Tensor, b2: torch.Tensor, P: int,
                noise: str = "f32") -> torch.Tensor:
    """The (P,) eps of one draw from per-pair bits (nblk, 32768)."""
    return block_layout(*box_muller(b1, b2, noise), P)


def noise_bits(P: int, seed: Tuple[int, int], draw: int, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b1, b2), each (nblk, 32768) int64, of one draw's streams: the noise
    contract in one place. Call j gives pairs j (words x0, x1) and
    j + 16384 (words x2, x3)."""
    nblk = -(-P // BLOCK_ELEMS)
    j = torch.arange(CALLS_PER_BLOCK, dtype=torch.int64, device=device)
    blk = torch.arange(nblk, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k1 = (int(seed[1]) + draw * nblk + blk) & _M32
    x0, x1, x2, x3 = philox4x32_10((j.expand(nblk, -1), zero, zero, zero),
                                   int(seed[0]) & _M32, k1)
    return torch.cat([x0, x2], dim=1), torch.cat([x1, x3], dim=1)


def noise_plain(P: int, seed: Tuple[int, int], num_draws: int,
                pair_values: Callable, device=None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(num_draws, P) of ``pair_values(b1, b2) -> (v_cos, v_sin)`` (f32)
    over each draw's bits, in the block layout, cast to ``out_dtype``: the
    plain version of every noise kernel (one draw at a time, to bound the
    int64 temporaries)."""
    out = torch.empty((num_draws, P), dtype=out_dtype, device=device)
    for d in range(num_draws):
        b1, b2 = noise_bits(P, seed, d, device)
        out[d] = block_layout(*pair_values(b1, b2), P)
    return out


def eps_plain(P: int, seed: Tuple[int, int], num_draws: int, device=None,
              noise: str = "f32") -> torch.Tensor:
    """The (num_draws, P) f32 eps of a seed: the noise of every plain
    version."""
    return noise_plain(P, seed, num_draws,
                       lambda b1, b2: box_muller(b1, b2, noise), device)


def stacked_plain(mu: torch.Tensor, sigma: torch.Tensor,
                  seed: Tuple[int, int], num_draws: int,
                  out_dtype: torch.dtype, fast_math: bool = False
                  ) -> torch.Tensor:
    """The plain version of the samplers: (num_draws, P) mu + sigma * eps,
    in f32, then cast."""
    eps = eps_plain(mu.shape[0], seed, num_draws, mu.device,
                    "fast" if fast_math else "f32")
    return (mu.to(torch.float32) + sigma.to(torch.float32) * eps).to(out_dtype)


def softplus_k(x: torch.Tensor) -> torch.Tensor:
    """The reparam kernel's softplus, ``_softplus``'s form in f32:
    where(x > 20, x, log1p(exp(min(x, 20)))). It differs from
    ``bayes.packing.softplus`` (``jax.nn.softplus``'s form, which the MC
    loops use) in the last ulp."""
    x = x.to(torch.float32)
    return torch.where(x > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp_max(x, 20.0))))


def reparam_plain(mu: torch.Tensor, rho: torch.Tensor, seed: Tuple[int, int],
                  num_draws: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the reparam kernel: (num_draws, P) mu +
    softplus_k(rho) * eps, in f32, then cast; by construction the stacked
    sampler's plain version at sigma = softplus_k(rho)."""
    return stacked_plain(mu, softplus_k(rho), seed, num_draws, out_dtype)


def split_plain(mu: torch.Tensor, sigma: torch.Tensor, seed: Tuple[int, int],
                num_draws: int, out_dtype: torch.dtype,
                fast_math: bool = False) -> List[torch.Tensor]:
    """The plain version of the split kernel, on any device."""
    return list(stacked_plain(mu, sigma, seed, num_draws, out_dtype,
                              fast_math).unbind(0))


_DTYPE_OK = (torch.float32, torch.bfloat16)
# the stacked sampler's entry with a device counter of its bf16 kernel's
# exact-path calls
COUNTED_ENTRY = "stacked_sampler_counted_launch"


def _fn(name: str, argtypes):
    fn = getattr(kernels.load("sampling"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def _current(device):
    """``device`` made the current card while a launch runs, and its
    current stream's handle: a launch on another card's stream fails, and
    the ctypes calls set no device of their own."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _check_vector_loads(mu, scale) -> None:
    if not (mu.is_contiguous() and scale.is_contiguous()):
        raise ValueError("mu and sigma must be contiguous")
    if mu.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("mu and sigma must start on a 16-byte boundary "
                         "(the kernels load them as vectors)")


def _launch(name: str, mu, scale, seed, num_draws, out_dtype,
            extra=(), exact_calls=None) -> torch.Tensor:
    """One launch of sampler ``name`` into a (num_draws, P) buffer;
    ``scale`` is sigma, or rho for the reparam sampler; ``seed``: the
    (seed0, seed1) words by value, or for the split and stacked samplers
    a (2,) int64 tensor on the device that the kernel reads (the split
    sampler takes only that; the stacked sampler's entry takes a device
    pointer, null for the words by value); ``extra``: trailing int
    arguments; ``exact_calls``: a (1,) int64 device tensor to which the
    stacked sampler's bf16 kernel adds its exact-path calls (its counted
    entry, ``COUNTED_ENTRY``)."""
    _check_vector_loads(mu, scale)
    P = mu.shape[0]
    out = mu.new_empty((num_draws, P), dtype=out_dtype)
    on_device = isinstance(seed, torch.Tensor)
    if name == "split_sampler":
        seed_args = [seed.data_ptr()]
        seed_types = [ctypes.c_void_p]
    else:
        words = (0, 0) if on_device else seed
        seed_args = [int(words[0]) & _M32, int(words[1]) & _M32]
        seed_types = [ctypes.c_uint, ctypes.c_uint]
        if name == "stacked_sampler":
            seed_args.insert(0, seed.data_ptr() if on_device else None)
            seed_types.insert(0, ctypes.c_void_p)
    args = [mu.data_ptr(), scale.data_ptr(), out.data_ptr(), P, num_draws,
            *seed_args, int(mu.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), *extra]
    types = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, *seed_types,
             ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * len(extra)
    entry = f"{name}_launch"
    if exact_calls is not None:
        entry = COUNTED_ENTRY
        args.append(exact_calls.data_ptr())
        types.append(ctypes.c_void_p)
    fn = _fn(entry, types + [ctypes.c_void_p])
    with _current(mu.device) as stream:
        kernels.check(fn(*args, stream), name)
    kernels.count(name)
    return out


def _check_seeds(seeds: torch.Tensor, device) -> None:
    if (seeds.dtype != torch.int64 or tuple(seeds.shape) != (2,)
            or seeds.device != device):
        raise ValueError(f"seeds: a (2,) int64 tensor on {device}, got "
                         f"{tuple(seeds.shape)} {seeds.dtype} on "
                         f"{seeds.device}")


@torch.library.custom_op("auv::split_sampler", mutates_args=(),
                         device_types="cpu")
def split_sampler(mu: torch.Tensor, sigma: torch.Tensor, seeds: torch.Tensor,
                  num_draws: int, out_dtype: torch.dtype,
                  fast_math: bool) -> torch.Tensor:
    """Kernel #1 as an op: (num_draws, P) draws mu + sigma * eps with the
    seed words read from ``seeds``. This body is the CPU implementation,
    the plain version."""
    return stacked_plain(mu, sigma, tuple(seeds.tolist()), num_draws,
                         out_dtype, fast_math)


@split_sampler.register_kernel("cuda")
def _split_sampler_cuda(mu, sigma, seeds, num_draws, out_dtype, fast_math):
    """The CUDA implementation: one launch of the kernel, which reads the
    seed words from device memory."""
    _check_seeds(seeds, mu.device)
    if not seeds.is_contiguous():
        raise ValueError("seeds must be contiguous")
    return _launch("split_sampler", mu, sigma, seeds, num_draws, out_dtype,
                   (int(fast_math),))


@split_sampler.register_fake
def _split_sampler_fake(mu, sigma, seeds, num_draws, out_dtype, fast_math):
    return mu.new_empty((num_draws, mu.shape[0]), dtype=out_dtype)


@torch.library.custom_op("auv::stacked_sampler", mutates_args=(),
                         device_types="cpu")
def stacked_sampler(mu: torch.Tensor, sigma: torch.Tensor,
                    seeds: torch.Tensor, num_draws: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel #2 as a forward-only op: (num_draws, P) draws mu + sigma *
    eps with the f32 noise, the seed words read from ``seeds``; the same
    values as the forward of ``gaussian_shift_scale`` at those words. This
    body is the CPU implementation, the plain version."""
    return stacked_plain(mu, sigma, tuple(seeds.tolist()), num_draws,
                         out_dtype)


@stacked_sampler.register_kernel("cuda")
def _stacked_sampler_cuda(mu, sigma, seeds, num_draws, out_dtype):
    """The CUDA implementation: one launch of the kernel, which reads the
    seed words from device memory."""
    _check_seeds(seeds, mu.device)
    if not seeds.is_contiguous():
        raise ValueError("seeds must be contiguous")
    return _launch("stacked_sampler", mu, sigma, seeds, num_draws, out_dtype)


@stacked_sampler.register_fake
def _stacked_sampler_fake(mu, sigma, seeds, num_draws, out_dtype):
    return mu.new_empty((num_draws, mu.shape[0]), dtype=out_dtype)


def stacked_exact_calls(mu: torch.Tensor, sigma: torch.Tensor, seed,
                        num_draws: int) -> Tuple[torch.Tensor, int]:
    """``stacked_draws(mu, sigma, seed, num_draws, out_dtype=bf16)`` on a
    CUDA tensor, and how many of its Philox calls took the bf16 kernel's
    exact path, by the kernel's own counter: the calls where the
    approximate noise's bracket left an element's bf16 rounding open. A
    measurement of the kernel (sampler_times.py, chip_smoke.py), on the
    card only; no user path passes a counter."""
    _check_args(mu, sigma, num_draws, torch.bfloat16)
    if not mu.is_cuda:
        raise ValueError("stacked_exact_calls counts the card's kernel: "
                         f"mu on {mu.device}")
    seeds = (seed if isinstance(seed, torch.Tensor)
             else seed_tensor(seed, mu.device))
    _check_seeds(seeds, mu.device)
    counter = torch.zeros(1, dtype=torch.int64, device=mu.device)
    out = _launch("stacked_sampler", mu, sigma, seeds, num_draws,
                  torch.bfloat16, exact_calls=counter)
    return out, int(counter.item())


def philox_calls(P: int, num_draws: int) -> int:
    """The noise contract's Philox calls for one launch over P elements and
    ``num_draws`` draws: one per call j whose element j lies inside P."""
    full, rem = divmod(P, BLOCK_ELEMS)
    return num_draws * (full * CALLS_PER_BLOCK + min(rem, CALLS_PER_BLOCK))


def launch_noise(name: str, P: int, seed, num_draws: int, device,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of noise kernel ``name`` (eps, or one of the RNG-split
    probe's) into a (num_draws, P) buffer on a CUDA device."""
    out = torch.empty((num_draws, P), dtype=out_dtype, device=device)
    fn = _fn(f"{name}_launch", [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                ctypes.c_int, ctypes.c_void_p])
    with _current(device) as stream:
        kernels.check(fn(out.data_ptr(), P, num_draws, int(seed[0]) & _M32,
                         int(seed[1]) & _M32,
                         int(out_dtype == torch.bfloat16), stream), name)
    kernels.count(name)
    return out


def _check_args(mu, sigma, num_draws, out_dtype):
    if mu.dim() != 1 or mu.shape != sigma.shape:
        raise ValueError(f"mu {tuple(mu.shape)} and sigma "
                         f"{tuple(sigma.shape)} must be equal 1-D shapes")
    if mu.shape[0] % LANES != 0:
        raise ValueError(f"packed size {mu.shape[0]} not a multiple of {LANES}")
    if mu.dtype != sigma.dtype or mu.dtype not in _DTYPE_OK \
            or out_dtype not in _DTYPE_OK:
        raise ValueError(f"dtypes mu={mu.dtype} sigma={sigma.dtype} "
                         f"out={out_dtype}: f32 or bf16, mu and sigma alike")
    if num_draws < 1:
        raise ValueError(f"num_draws={num_draws} must be >= 1")
    if mu.device != sigma.device:
        raise ValueError(f"mu on {mu.device}, sigma on {sigma.device}")
    if not mu.is_cuda and mu.device.type != "cpu":
        raise ValueError(f"no sampler for device {mu.device}")


def split_draws(mu: torch.Tensor, sigma: torch.Tensor, seed, num_draws: int,
                *, out_dtype: torch.dtype = None,
                fast_math: bool = False) -> torch.Tensor:
    """``num_draws`` posterior draws mu + sigma * eps as one (num_draws, P)
    tensor. Not differentiable.

    ``seed``: a (2,) int64 tensor on mu's device (the main path's: one row
    of the step's seed tensor, no host round trip), or a (seed0, seed1)
    pair, copied to the device first. ``fast_math``: the bf16-budget
    polynomials of ``_normal_block_fast``; bf16 outputs only. One call of
    the op ``auv::split_sampler``: on a CUDA tensor it launches the kernel
    or raises; on a CPU tensor it runs the plain version."""
    out_dtype = out_dtype or mu.dtype
    if fast_math and out_dtype != torch.bfloat16:
        raise ValueError("fast_math sampling is bf16-output-only (its error "
                         f"budget is the bf16 quantum); got {out_dtype}")
    _check_args(mu, sigma, num_draws, out_dtype)
    seeds = (seed if isinstance(seed, torch.Tensor)
             else seed_tensor(seed, mu.device))
    _check_seeds(seeds, mu.device)
    return torch.ops.auv.split_sampler(mu, sigma, seeds, num_draws,
                                       out_dtype, fast_math)


def stacked_draws(mu: torch.Tensor, sigma: torch.Tensor, seed,
                  num_draws: int, *,
                  out_dtype: torch.dtype = None) -> torch.Tensor:
    """``num_draws`` posterior draws mu + sigma * eps with the f32 noise, as
    one (num_draws, P) tensor: the forward of ``gaussian_shift_scale``,
    not differentiable. ``seed``: a (2,) int64 tensor on mu's device, or a
    (seed0, seed1) pair, copied to the device first. One call of the op
    ``auv::stacked_sampler`` (what an exported mc-sharded program calls):
    on a CUDA tensor it launches the kernel, which reads the seed words
    from device memory, or raises; on a CPU tensor it runs the plain
    version."""
    out_dtype = out_dtype or mu.dtype
    _check_args(mu, sigma, num_draws, out_dtype)
    seeds = (seed if isinstance(seed, torch.Tensor)
             else seed_tensor(seed, mu.device))
    _check_seeds(seeds, mu.device)
    return torch.ops.auv.stacked_sampler(mu, sigma, seeds, num_draws,
                                         out_dtype)


def gaussian_shift_scale_split(mu: torch.Tensor, sigma: torch.Tensor,
                               seed, num_draws: int, *,
                               out_dtype: torch.dtype = None,
                               fast_math: bool = False) -> List[torch.Tensor]:
    """``split_draws`` as a list of flat (P,) tensors (views of its one
    (num_draws, P) buffer)."""
    return list(split_draws(mu, sigma, seed, num_draws, out_dtype=out_dtype,
                            fast_math=fast_math).unbind(0))


def check_noise_args(P: int, num_draws: int, device, out_dtype
                     ) -> torch.device:
    """The device of a noise kernel's call, or ValueError for arguments no
    noise kernel takes."""
    device = torch.device(device)
    if P <= 0 or P % LANES != 0 or num_draws < 1:
        raise ValueError(f"P={P} (a positive multiple of {LANES}) and "
                         f"num_draws={num_draws} (>= 1)")
    if out_dtype not in _DTYPE_OK:
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no sampler for device {device}")
    return device


def gaussian_noise(P: int, seed: Tuple[int, int], num_draws: int, device,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (num_draws, P) eps that ``gaussian_shift_scale`` draws for
    ``seed``, computed in f32 and cast to ``out_dtype`` (the port of
    ``_pallas_eps``). On a CUDA device this launches the eps kernel; on the
    CPU it runs ``eps_plain``."""
    device = check_noise_args(P, num_draws, device, out_dtype)
    if device.type == "cuda":
        return launch_noise("eps", P, seed, num_draws, device, out_dtype)
    return eps_plain(P, seed, num_draws, device).to(out_dtype)


def noise_parts_plain(n: int, noise: str = "f32", device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r, sin t, cos t), each (n,) f32, of Box-Muller on words 0..n-1 as
    b1 and as b2: r = sqrt(-2 ln u1) and ``fast_sincos_2pi(u2)``, the
    pieces of ``box_muller``."""
    _check_noise(noise)
    w = torch.arange(n, dtype=torch.int64, device=device)
    f1 = ((w & _M24) + 1).to(torch.float32)
    r = torch.sqrt(-2.0 * (fast_ln(f1, noise) - 24.0 * _LN2))
    u2 = (w & _M24).to(torch.float32) * (1.0 / 16777216.0)
    sin_t, cos_t = fast_sincos_2pi(u2, noise)
    return r, sin_t, cos_t


def noise_parts(n: int, noise: str = "f32", device="cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``noise_parts_plain`` as the kernels compute it: on a CUDA device
    one launch of ``noise_parts`` (the device functions every noise kernel
    draws through, on all n <= 2^24 words), on the CPU the plain version.
    A check of the kernels' exact forms, not a sampler."""
    _check_noise(noise)
    _check_words(n)
    device = torch.device(device)
    if device.type != "cuda":
        return noise_parts_plain(n, noise, device)
    return _parts_launch(n, NOISE_MODES.index(noise), device)


def _check_words(n: int) -> None:
    if not 0 < n <= 1 << 24:
        raise ValueError(f"n={n}: 1 .. 2^24 words")


def _parts_launch(n: int, mode: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``noise_parts`` on the card: the polynomial set of
    ``NOISE_MODES[mode]``, or (mode 3) the bf16 stacked kernel's
    approximations."""
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    fn = _fn("noise_parts_launch", [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with _current(device) as stream:
        kernels.check(fn(out[0].data_ptr(), out[1].data_ptr(),
                         out[2].data_ptr(), n, mode, stream), "noise_parts")
    kernels.count("noise_parts")
    return out[0], out[1], out[2]


# The bf16 stacked kernel's bracket (csrc/sampling.cu, bf16_stacked_kernel):
# each value z of a pair is approximated by z' with |z' - z| <= E =
# E_r[bracket_bucket(b1)] + r' E_sc, and where mu + sigma (z' -/+ E) round
# to the same bf16 bits the kernel keeps them (``bracket_bf16``).
BRACKET_SLOTS = 25
BRACKET_FLOOR = 1e-30


def approx_parts_plain(n: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the bf16 stacked kernel's approximations approximate, for words
    0..n-1 as b1 and as b2, laid out as ``noise_parts_plain``: r =
    sqrt(2 ln 2 (24 - log2 f1)) and (sin, cos) 2 pi u2, in f64 rounded to
    f32. The card's MUFU results (``approx_parts``) differ from these by
    their approximation errors: no CPU version has their bits."""
    w = torch.arange(n, dtype=torch.int64, device=device)
    f1 = ((w & _M24) + 1).to(torch.float64)
    r = torch.sqrt(torch.clamp_min((24.0 - torch.log2(f1)) * (2 * _LN2), 0))
    t = (w & _M24).to(torch.float64) * (2 * _PI / 16777216.0)
    return (r.to(torch.float32), torch.sin(t).to(torch.float32),
            torch.cos(t).to(torch.float32))


def approx_parts(n: int, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 stacked kernel's approximate radius and (sin, cos) of words
    0..n-1 (n <= 2^24), laid out as ``noise_parts``: on a CUDA device one
    launch of ``noise_parts`` in its approximate mode, the device functions
    the kernel's fast path calls; on the CPU ``approx_parts_plain``. How
    the bracket's constants are measured, not a sampler."""
    _check_words(n)
    device = torch.device(device)
    if device.type != "cuda":
        return approx_parts_plain(n, device)
    return _parts_launch(n, len(NOISE_MODES), device)


def bracket_bucket(words: torch.Tensor) -> torch.Tensor:
    """The bracket's table index of each word as b1: the bit length of g =
    2^24 - f1 = 0xFFFFFF - (b1 & 0xFFFFFF), 0 for g = 0 (the kernel reads
    it from the exponent field of the f32 g, which is exact)."""
    g = _M24 - (words.to(torch.int64) & _M24)
    _, exp = torch.frexp(g.to(torch.float64))
    return torch.where(g > 0, exp, 0).to(torch.int64)


def bracket_deviations(exact, approx) -> Tuple[torch.Tensor, torch.Tensor,
                                               float]:
    """Per-word deviations of the approximate parts from the exact ones,
    each ``(r, sin, cos)`` over the same words: |r' - r| per word, the
    larger of |sin' - sin| and |cos' - cos| per word, and C, the largest
    |sin| or |cos| of either (at least 1), in f64."""
    (r, s, c), (ra, sa, ca) = ([t.double() for t in p] for p in (exact,
                                                                  approx))
    dev_r = (ra - r).abs()
    dev_sc = torch.maximum((sa - s).abs(), (ca - c).abs())
    c_max = max(1.0, *(float(t.abs().max()) for t in (s, c, sa, ca)))
    return dev_r, dev_sc, c_max


def bracket_constants(dev_r: torch.Tensor, buckets: torch.Tensor,
                      dev_sc: torch.Tensor, c_max: float,
                      margin: float = 1.0) -> Tuple[List[float], float]:
    """The bracket's table E_r (BRACKET_SLOTS values, by ``buckets``, the
    ``bracket_bucket`` of each word of ``dev_r``) and E_sc from per-word
    deviations (``bracket_deviations``), times ``margin``. With dR the
    largest radius deviation of a bucket, dS the largest sin / cos one and
    C >= every |sin| and |cos|, the pair's value z = fl(r c) and its
    approximation z' = fl(r' c') differ by at most |r' - r| |c'| + r |c' -
    c| + 2^-24 (|r c| + |r' c'|) <= dR (C + dS + 2^-24 C) + r' (dS + 2^-23
    C), using r <= r' + dR: E_r = dR (C + dS + 2^-24 C), E_sc = dS + 2^-23
    C. Every E_r is at least BRACKET_FLOOR, so that E > 0 and RD(z' - E) <
    z' < RU(z' + E) even where the deviations are 0 (an exact z of -0
    beside z' = +0 must then straddle)."""
    d_r = torch.zeros(BRACKET_SLOTS, dtype=torch.float64)
    d_r = d_r.scatter_reduce(0, buckets.cpu(), dev_r.double().cpu(), "amax")
    d_s = float(dev_sc.max())
    e_r = d_r * (c_max + d_s + 2.0 ** -24 * c_max) * margin
    return (e_r.clamp_min(BRACKET_FLOOR).tolist(),
            (d_s + 2.0 ** -23 * c_max) * margin)


def library_bracket_constants() -> Tuple[List[float], float]:
    """The bracket constants the built kernel library holds (E_r, E_sc), as
    f32 values: what its bf16 stacked kernel uses."""
    out = (ctypes.c_float * (BRACKET_SLOTS + 1))()
    fn = _fn("bracket_constants", [ctypes.c_void_p, ctypes.c_int])
    if fn(out, BRACKET_SLOTS + 1) != BRACKET_SLOTS + 1:
        raise RuntimeError("bracket_constants: the library's table size "
                           f"differs from {BRACKET_SLOTS}")
    return list(out[:BRACKET_SLOTS]), out[BRACKET_SLOTS]


def _add_directed(x: torch.Tensor, y: torch.Tensor, up: bool
                  ) -> torch.Tensor:
    """x + y for f32 tensors rounded toward +inf (``up``) or -inf, as the
    kernel's __fadd_ru / __fsub_rd: the round-to-nearest sum and its exact
    error by TwoSum (Knuth), moved one f32 step where the error points
    the other way; an exact zero is -0 rounding down unless both terms
    are +0, and +0 rounding up unless both are -0."""
    s = x + y
    bp = s - x
    t = (x - (s - bp)) + (y - bp)
    inf = torch.full_like(s, float("inf") if up else -float("inf"))
    moved = torch.where(t > 0 if up else t < 0, torch.nextafter(s, inf), s)
    zero = (moved == 0) & (t == 0)
    neg = torch.signbit(x) & torch.signbit(y)
    if up:
        return torch.where(zero, torch.where(neg, -0.0, 0.0), moved)
    pos = ~torch.signbit(x) & ~torch.signbit(y)
    return torch.where(zero, torch.where(pos, 0.0, -0.0), moved)


def bracket_bf16(mu: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor,
                 e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the bf16 stacked kernel's decision per element
    (f32 inputs, E > 0): lo = fl(mu + fl(sigma RD(z - e))) and hi = fl(mu +
    fl(sigma RU(z + e))) rounded to bf16. Returns lo's bf16 bits (int16)
    and the safe mask, where lo's and hi's bits are equal: there, every z
    within e of ``z`` gives those bits as bf16(fl(mu + fl(sigma z)))."""
    a = _add_directed(z, -e, up=False)
    b = _add_directed(z, e, up=True)
    lo = (mu + sigma * a).to(torch.bfloat16).view(torch.int16)
    hi = (mu + sigma * b).to(torch.bfloat16).view(torch.int16)
    return lo, lo == hi


class _GaussianShiftScale(torch.autograd.Function):
    """``_gss``: forward w = mu + sigma * eps (stacked kernel); backward
    dmu = sum_d g, dsigma = sum_d g * eps with eps regenerated from the
    seed (eps kernel). Nothing but the seed is kept for the backward: no
    eps, no w, no mu or sigma."""

    @staticmethod
    def forward(ctx, mu, sigma, seed0, seed1, num_draws, out_dtype):
        ctx.seed = (seed0, seed1)
        ctx.num_draws = num_draws
        ctx.dtypes = (mu.dtype, sigma.dtype)
        ctx.P, ctx.device = mu.shape[0], mu.device
        if mu.is_cuda:
            return _launch("stacked_sampler", mu, sigma, (seed0, seed1),
                           num_draws, out_dtype)
        return stacked_plain(mu, sigma, (seed0, seed1), num_draws, out_dtype)

    @staticmethod
    def backward(ctx, g):
        eps = gaussian_noise(ctx.P, ctx.seed, ctx.num_draws, ctx.device)
        g32 = g.to(torch.float32)
        dmu = g32.sum(dim=0).to(ctx.dtypes[0])
        dsigma = (g32 * eps).sum(dim=0).to(ctx.dtypes[1])
        return dmu, dsigma, None, None, None, None


def gaussian_shift_scale(mu: torch.Tensor, sigma: torch.Tensor,
                         seed: Tuple[int, int], num_draws: int, *,
                         out_dtype: torch.dtype = None,
                         fast_math: bool = False) -> torch.Tensor:
    """(num_draws, P) posterior draws mu + sigma * eps with a precomputed
    sigma = softplus(rho), differentiable in mu and sigma.

    f32 noise only: ``fast_math`` is refused, because the backward
    regenerates eps with the f32 generator and must see the forward's eps
    bit for bit. On a CUDA tensor this launches the kernels or raises; on
    a CPU tensor it runs their plain versions."""
    if fast_math:
        raise ValueError("fast_math is refused on the differentiable path: "
                         "its backward regenerates the f32 eps and must "
                         "match the forward bit for bit")
    out_dtype = out_dtype or mu.dtype
    _check_args(mu, sigma, num_draws, out_dtype)
    return _GaussianShiftScale.apply(mu, sigma, int(seed[0]) & _M32,
                                     int(seed[1]) & _M32, num_draws,
                                     out_dtype)


def gaussian_reparam(mu: torch.Tensor, rho: torch.Tensor,
                     seed: Tuple[int, int], num_draws: Optional[int] = None,
                     *, out_dtype: torch.dtype = None) -> torch.Tensor:
    """w = mu + softplus_k(rho) * eps: (P,) when ``num_draws`` is None, else
    (num_draws, P). mu and rho are f32 or bf16, alike; ``out_dtype``
    defaults to mu's. The noise is the other samplers' at the same seed,
    so ``gaussian_reparam(mu, rho, s, n)`` equals
    ``gaussian_shift_scale(mu, softplus_k(rho), s, n)``.

    Not differentiable, as the JAX package's ``_pallas_reparam`` with
    ``_reparam_kernel`` has no VJP: with grad mode on and mu or rho
    requiring grad it raises ValueError (call it under ``torch.no_grad()``,
    or train through ``gaussian_shift_scale``). On a CUDA tensor this
    launches the kernel or raises; on a CPU tensor it runs
    ``reparam_plain``."""
    n = 1 if num_draws is None else num_draws
    out_dtype = out_dtype or mu.dtype
    if torch.is_grad_enabled() and (mu.requires_grad or rho.requires_grad):
        raise ValueError(
            "gaussian_reparam has no backward (the JAX package's "
            "_reparam_kernel has no VJP): call it under torch.no_grad(), or "
            "differentiate through gaussian_shift_scale")
    _check_args(mu, rho, n, out_dtype)
    if mu.is_cuda:
        out = _launch("reparam_sampler", mu, rho, seed, n, out_dtype)
    else:
        out = reparam_plain(mu, rho, seed, n, out_dtype)
    return out[0] if num_draws is None else out
