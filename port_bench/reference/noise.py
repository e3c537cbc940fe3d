"""The posterior samplers' noise, plain PyTorch (a frozen copy of the
noise contract the program's sampler kernels implement).

The contract, word for word as the program documents it:

* P elements form blocks of 512 x 128 = 65536; the last block may be
  partial, and nothing is written past P.
* Stream (draw, blk) is Philox-4x32-10 keyed (seed0, seed1 + draw * nblk
  + blk) mod 2^32.
* Call j in [0, 16384) of a stream uses counter (j, 0, 0, 0) and gives
  words (x0, x1, x2, x3): pair j takes (x0, x1) and pair j + 16384 takes
  (x2, x3) as its bits (b1, b2).
* Pair i in [0, 32768) of a block is the element pair (i, i + 32768).
* Box-Muller on two 24-bit uniforms: u1 = ((b1 & 0xFFFFFF) + 1) / 2^24,
  u2 = (b2 & 0xFFFFFF) / 2^24, r = sqrt(-2 ln u1); the pair takes
  (r cos 2 pi u2, r sin 2 pi u2).

The reference takes ln, sin and cos from PyTorch in float64 and rounds
to float32: it is the exact Box-Muller of the contract's bits, not the
program's polynomial approximations of it, so the comparison judges
those too. Seeds are pairs of 32-bit words.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

BLOCK_ELEMS = 512 * 128
CALLS_PER_BLOCK = BLOCK_ELEMS // 4
_M32 = 0xFFFFFFFF
_M24 = 0xFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x, x uint32 values held in int64,
    through 16-bit limbs so that no product overflows."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(ctr: Sequence[torch.Tensor], k0, k1):
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors of uint32."""
    c0, c1, c2, c3 = ctr
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw_bits(P: int, seed: Tuple[int, int], draw: int, device=None):
    """(b1, b2), each (nblk, 32768) int64: one draw's bits."""
    nblk = -(-P // BLOCK_ELEMS)
    j = torch.arange(CALLS_PER_BLOCK, dtype=torch.int64, device=device)
    blk = torch.arange(nblk, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k1 = (int(seed[1]) + draw * nblk + blk) & _M32
    x0, x1, x2, x3 = philox4x32_10((j.expand(nblk, -1), zero, zero, zero),
                                   int(seed[0]) & _M32, k1)
    return torch.cat([x0, x2], dim=1), torch.cat([x1, x3], dim=1)


def eps(P: int, seed: Tuple[int, int], draw: int, device=None
        ) -> torch.Tensor:
    """The (P,) float32 standard normals of draw ``draw`` of ``seed``."""
    b1, b2 = draw_bits(P, seed, draw, device)
    u1 = ((b1 & _M24) + 1).to(torch.float64) / 16777216.0
    u2 = (b2 & _M24).to(torch.float64) / 16777216.0
    del b1, b2
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = (2.0 * math.pi) * u2
    pair = torch.stack([r * torch.cos(t), r * torch.sin(t)], dim=1)
    return pair.reshape(-1)[:P].to(torch.float32)


def offset_seed(seed: Tuple[int, int], draw0: int, P: int):
    """The seed whose draw d is draw ``draw0 + d`` of ``seed``."""
    nblk = -(-P // BLOCK_ELEMS)
    return (int(seed[0]) & _M32, (int(seed[1]) + draw0 * nblk) & _M32)
