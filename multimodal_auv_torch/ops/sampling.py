"""Split posterior sampler: ``num_draws`` draws w_d = mu + sigma * eps_d.

Port of the split path of ``multimodal_auv_tpu/ops/sampling.py``
(``gaussian_shift_scale_split`` and its Pallas kernel
``_pallas_reparam_split``). On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/sampling.cu``; on a CPU tensor it runs the
plain PyTorch version below, which does the same arithmetic op for op, so
the two agree bit for bit on the card.

The noise contract (shared with the later stacked and noise-only kernels,
which must regenerate the same eps from the same seed):

* P elements form blocks of 512 x 128 = 65536 (``BLOCK_ROWS`` x ``LANES``);
  the last block may be partial.
* Stream (draw, blk) is Philox-4x32-10 keyed
  (seed0, seed1 + draw * nblk + blk) mod 2^32.
* Pair i in [0, 32768) of a block is the element pair (i, i + 32768) and
  uses counter (i, 0, 0, 0); words x0, x1 are the bits b1, b2.
* Box-Muller on two 24-bit uniforms, with the JAX package's fast-math ln and
  sin/cos polynomials in f32: u1 = (b1 & 0xFFFFFF + 1) / 2^24,
  u2 = (b2 & 0xFFFFFF) / 2^24, r = sqrt(-2 ln u1); the pair takes
  (r cos 2 pi u2, r sin 2 pi u2).

A seed is a pair of 32-bit words, the counterpart of the JAX package's
``_seed_from_key``; callers draw it from a ``torch.Generator``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from multimodal_auv_torch.ops import kernels

LANES = 128
BLOCK_ROWS = 512
BLOCK_ELEMS = BLOCK_ROWS * LANES
PAIRS_PER_BLOCK = BLOCK_ELEMS // 2

_M32 = 0xFFFFFFFF
_M24 = 0xFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# Python doubles as the JAX package writes them; each is rounded to f32
# where it meets an f32 tensor, as JAX's weakly typed constants are.
_LN2 = 0.6931471805599453
_TWO_PI = 6.283185307179586
_PI = 3.141592653589793


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


def fast_ln(f: torch.Tensor, trimmed: bool = False) -> torch.Tensor:
    """``_fast_ln`` (``trimmed=False``) / ``_fast_ln_bf16``: ln(f) for f32 f
    in [1, 2^24] via exponent bits and the atanh series of the mantissa."""
    i = f.view(torch.int32)
    e = (i >> 23) - 127
    m = ((i & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    z = (m - 1.0) / (m + 1.0)
    z2 = z * z
    if trimmed:
        p = 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0))
    else:
        p = 1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (
            1.0 / 7.0 + z2 * (1.0 / 9.0))))
    return e.to(torch.float32) * _LN2 + 2.0 * z * p


def fast_sincos_2pi(u: torch.Tensor, trimmed: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fast_sincos_2pi`` / ``_fast_sincos_2pi_bf16``: (sin 2 pi u,
    cos 2 pi u) for f32 u in [0, 1), by quadrant reduction and Taylor
    polynomials."""
    x = (u - 0.5) * _TWO_PI
    q = torch.floor(x * (2.0 / _PI) + 0.5)
    y = x - q * (_PI / 2.0)
    y2 = y * y
    if trimmed:
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


def box_muller(b1: torch.Tensor, b2: torch.Tensor, fast_math: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r cos t, r sin t) f32 normals from two words of random bits (int
    tensors; the low 24 bits of each are used)."""
    f1 = ((b1 & _M24) + 1).to(torch.float32)
    ln_u1 = fast_ln(f1, fast_math) - 24.0 * _LN2
    u2 = (b2 & _M24).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * ln_u1)
    sin_t, cos_t = fast_sincos_2pi(u2, fast_math)
    return r * cos_t, r * sin_t


def block_noise(b1: torch.Tensor, b2: torch.Tensor, P: int,
                fast_math: bool = False) -> torch.Tensor:
    """Lay out per-pair bits (nblk, 32768) as the (P,) eps of one draw: pair
    i of block k fills elements k*65536 + i and k*65536 + 32768 + i."""
    z_cos, z_sin = box_muller(b1, b2, fast_math)
    return torch.stack([z_cos, z_sin], dim=1).reshape(-1)[:P]


def noise_bits(P: int, seed: Tuple[int, int], draw: int, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b1, b2), each (nblk, 32768) int64, of one draw's streams."""
    nblk = -(-P // BLOCK_ELEMS)
    i = torch.arange(PAIRS_PER_BLOCK, dtype=torch.int64, device=device)
    blk = torch.arange(nblk, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k1 = (int(seed[1]) + draw * nblk + blk) & _M32
    x0, x1, _, _ = philox4x32_10((i.expand(nblk, -1), zero, zero, zero),
                                 int(seed[0]) & _M32, k1)
    return x0, x1


def split_plain(mu: torch.Tensor, sigma: torch.Tensor, seed: Tuple[int, int],
                num_draws: int, out_dtype: torch.dtype,
                fast_math: bool = False) -> List[torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    P = mu.shape[0]
    mu32, sg32 = mu.to(torch.float32), sigma.to(torch.float32)
    outs = []
    for d in range(num_draws):
        b1, b2 = noise_bits(P, seed, d, mu.device)
        eps = block_noise(b1, b2, P, fast_math)
        outs.append((mu32 + sg32 * eps).to(out_dtype))
    return outs


_DTYPE_OK = (torch.float32, torch.bfloat16)


def _launch_split(mu, sigma, seed, num_draws, out_dtype, fast_math):
    lib = kernels.load("sampling")
    fn = lib.split_sampler_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    P = mu.shape[0]
    out = torch.empty((num_draws, P), dtype=out_dtype, device=mu.device)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    rc = fn(mu.data_ptr(), sigma.data_ptr(), out.data_ptr(), P, num_draws,
            int(seed[0]) & _M32, int(seed[1]) & _M32,
            int(mu.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(fast_math), stream)
    kernels.check(rc, "split_sampler")
    kernels.LAUNCHES["split_sampler"] += 1
    return list(out.unbind(0))


def gaussian_shift_scale_split(mu: torch.Tensor, sigma: torch.Tensor,
                               seed: Tuple[int, int], num_draws: int, *,
                               out_dtype: torch.dtype = None,
                               fast_math: bool = False) -> List[torch.Tensor]:
    """``num_draws`` posterior draws mu + sigma * eps as a list of flat (P,)
    tensors (views of one (num_draws, P) buffer). Not differentiable.

    ``fast_math``: the bf16-budget polynomials of ``_normal_block_fast``;
    bf16 outputs only. On a CUDA tensor this launches the kernel or raises;
    on a CPU tensor it runs the plain version."""
    out_dtype = out_dtype or mu.dtype
    if fast_math and out_dtype != torch.bfloat16:
        raise ValueError("fast_math sampling is bf16-output-only (its error "
                         f"budget is the bf16 quantum); got {out_dtype}")
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
    if mu.is_cuda:
        if not (mu.is_contiguous() and sigma.is_contiguous()):
            raise ValueError("mu and sigma must be contiguous")
        return _launch_split(mu, sigma, seed, num_draws, out_dtype, fast_math)
    if mu.device.type == "cpu":
        return split_plain(mu, sigma, seed, num_draws, out_dtype, fast_math)
    raise ValueError(f"no sampler for device {mu.device}")
