"""The chip's peaks and the least time of the sampler kernels' calls.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989e12 bf16 FLOP/s on the tensor cores and 3.35e12 B/s of HBM. The
samplers' operations are counted as the kernels issue them: they are
built with --fmad=false, so no multiply and add fuse, and one SM issues
128 float32 instructions a clock (CUDA C++ Programming Guide, arithmetic
throughput, compute capability 9.0): 132 SMs x 128 x 1.98 GHz boost.

A call's least time is the larger of its bytes at the HBM rate (each
input read once, each output written once) and its operations at the
float32 rate. Operations per element pair and draw: the Box-Muller with
the f32 polynomials and two mu + sigma * eps, 53; with the bf16-budget
("fast") polynomials, 41; the noise alone (the eps kernel), 53 - 4.
"""
from __future__ import annotations

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9
SAMPLER_F32_OPS = {False: 53, True: 41}
EPS_F32_OPS = SAMPLER_F32_OPS[False] - 4
BYTES = {"float32": 4, "bfloat16": 2}


def sampler_call(kind: str, P: int, draws: int, in_dtype: str,
                 out_dtype: str, fast: bool = False):
    """(bytes, float32 operations) of one call. ``kind``: "split" or
    "stacked" (mu and sigma in, ``draws`` rows out) or "eps" (rows of
    noise out)."""
    out_bytes = draws * P * BYTES[out_dtype]
    if kind == "eps":
        return out_bytes, (P // 2) * draws * EPS_F32_OPS
    if kind not in ("split", "stacked"):
        raise ValueError(f"sampler kind {kind!r}")
    return (2 * P * BYTES[in_dtype] + out_bytes,
            (P // 2) * draws * SAMPLER_F32_OPS[bool(fast)])


def least_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
