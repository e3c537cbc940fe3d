"""Split the samplers' per-draw cost on the card into "random bits + write"
and "Box-Muller math".

Port of ``scripts/probe_rng_split.py``. Four noise kernels of
``csrc/sampling.cu`` draw from the samplers' streams (the noise contract of
``ops/sampling.py``) and write a (num_draws, P) buffer:

* ``rng_bits`` (``_bits_kernel``): each pair's two words as floats,
  f1 = (b1 & 0xFFFFFF) + 1 and f2 = b2 & 0xFFFFFF, where the eps kernel
  writes (r cos t, r sin t): the eps kernel with Box-Muller removed, the
  floor of "Philox + write";
* ``eps`` (``_eps_kernel``, kernel #3, row ``bm``): the f32 polynomials;
* ``rng_bmlite`` (``_bmlite_kernel``): Box-Muller with the 2-term ln series
  ``_fast_ln_lite`` and the trimmed sin/cos ``_fast_sincos_2pi_lite``;
* ``eps_fast`` (``_bmfast_kernel``): the split sampler's bf16-budget
  polynomials (``_normal_block_fast``) as noise alone, bf16 out.

Each wrapper launches its kernel on a CUDA device (or raises) and runs its
plain version, built on ``noise_bits`` and ``box_muller``, on the CPU.

On the card, at the TPU probe's geometry (72,941,568 elements, 20 draws,
bf16 out):

    python -m multimodal_auv_torch.ops.probe_rng_split

prints the marginal ms per draw of each kernel, (t(20) - t(1)) / 19 by CUDA
events, the split derived from them, and the lite polynomials against the
f32 ones on the same bits (f32, 2 draws): max and mean |difference| and the
lite noise's moments.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

import torch

from multimodal_auv_torch.ops import sampling as S

# the TPU probe's geometry: ~73M elements rounded down to whole blocks
PROBE_P = (73_000_000 // S.LANES // S.BLOCK_ROWS) * S.BLOCK_ROWS * S.LANES
PROBE_DRAWS = 20
PROBE_SEED = (12345, 0)
ROWS = ("bits", "bm", "bmlite", "bmfast")


def bits_pair(b1: torch.Tensor, b2: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_bits_kernel``'s values of a pair: the two 24-bit words as f32."""
    return (((b1 & 0xFFFFFF) + 1).to(torch.float32),
            (b2 & 0xFFFFFF).to(torch.float32))


def rng_bits_plain(P, seed, num_draws, device=None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    return S.noise_plain(P, seed, num_draws, bits_pair, device, out_dtype)


def rng_bmlite_plain(P, seed, num_draws, device=None,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    return S.noise_plain(P, seed, num_draws,
                         lambda b1, b2: S.box_muller(b1, b2, "lite"),
                         device, out_dtype)


def eps_fast_plain(P, seed, num_draws, device=None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    return S.eps_plain(P, seed, num_draws, device, "fast").to(out_dtype)


def bm_plain(P, seed, num_draws, device=None,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of the probe's ``bm``: the f32 eps, cast."""
    return S.eps_plain(P, seed, num_draws, device).to(out_dtype)


def _noise(name, plain, P, seed, num_draws, device, out_dtype):
    device = S.check_noise_args(P, num_draws, device, out_dtype)
    if device.type == "cuda":
        return S.launch_noise(name, P, seed, num_draws, device, out_dtype)
    return plain(P, seed, num_draws, device, out_dtype)


def rng_bits(P: int, seed: Tuple[int, int], num_draws: int, device,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(num_draws, P) of the pairs' words as floats (``_bits_kernel``)."""
    return _noise("rng_bits", rng_bits_plain, P, seed, num_draws, device,
                  out_dtype)


def rng_bmlite(P: int, seed: Tuple[int, int], num_draws: int, device,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(num_draws, P) lite Box-Muller noise (``_bmlite_kernel``)."""
    return _noise("rng_bmlite", rng_bmlite_plain, P, seed, num_draws, device,
                  out_dtype)


def eps_fast(P: int, seed: Tuple[int, int], num_draws: int, device,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(num_draws, P) bf16 noise of the bf16-budget polynomials
    (``_bmfast_kernel``); bf16 out only, as the split sampler's fast path."""
    if out_dtype != torch.bfloat16:
        raise ValueError(f"eps_fast is bf16-output-only; got {out_dtype}")
    return _noise("eps_fast", eps_fast_plain, P, seed, num_draws, device,
                  out_dtype)


def bm(P: int, seed: Tuple[int, int], num_draws: int, device,
       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The eps kernel (kernel #3) at ``out_dtype``: the probe's ``bm``."""
    return S.gaussian_noise(P, seed, num_draws, device, out_dtype)


NOISE = {"bits": rng_bits, "bm": bm, "bmlite": rng_bmlite, "bmfast": eps_fast}
# the probe's own kernels: launch name -> (wrapper, plain version)
KERNELS = {"rng_bits": (rng_bits, rng_bits_plain),
           "rng_bmlite": (rng_bmlite, rng_bmlite_plain),
           "eps_fast": (eps_fast, eps_fast_plain)}
# every kernel the probe launches, the eps kernel (its ``bm``) included
LAUNCHED = dict(KERNELS, eps=(bm, bm_plain))


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def launches_of_run(iters: int) -> Dict[str, int]:
    """The kernel launches one ``run(iters=iters)`` makes: (iters + 1)
    timed calls at each draw count, and the fidelity check's eps and
    rng_bmlite calls."""
    n = 2 * (iters + 1)
    return {"rng_bits": n, "eps": n + 1, "rng_bmlite": n + 1, "eps_fast": n}


def _moments(a: torch.Tensor) -> Dict[str, float]:
    a = a.double().reshape(-1)
    c = a - a.mean()
    sd = c.pow(2).mean().sqrt()
    return {"mean": float(a.mean()), "std": float(a.std()),
            "skew": float(c.pow(3).mean() / sd ** 3),
            "kurt": float(c.pow(4).mean() / sd ** 4 - 3)}


def run(P: int = PROBE_P, num_draws: int = PROBE_DRAWS,
        seed: Tuple[int, int] = PROBE_SEED, iters: int = 10,
        out_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The probe on the card: per row, t(num_draws), t(1) and the marginal
    ms per draw; the split; lite against the f32 polynomials on the same
    bits. Raises without a CUDA device: its numbers are the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("the RNG-split probe measures the card: no CUDA "
                           "device")
    dev = torch.device("cuda")
    rows = {}
    for row in ROWS:
        fn = NOISE[row]
        t_n = cuda_ms(lambda: fn(P, seed, num_draws, dev, out_dtype), iters)
        t_1 = cuda_ms(lambda: fn(P, seed, 1, dev, out_dtype), iters)
        rows[row] = {"t_n_ms": t_n, "t_1_ms": t_1,
                     "marginal_ms": (t_n - t_1) / (num_draws - 1)}
    m = {k: v["marginal_ms"] for k, v in rows.items()}
    split = {"prng_write_ms": m["bits"],
             "bm_math_prod_ms": m["bm"] - m["bits"],
             "bm_math_lite_ms": m["bmlite"] - m["bits"],
             "bm_math_fast_ms": m["bmfast"] - m["bits"],
             "lite_saves_ms": m["bm"] - m["bmlite"],
             "fast_saves_ms": m["bm"] - m["bmfast"]}
    w_bm = bm(P, seed, 2, dev, torch.float32)
    w_lt = rng_bmlite(P, seed, 2, dev, torch.float32)
    d = (w_bm - w_lt).abs()
    fidelity = {"max_abs_diff": float(d.max()),
                "mean_abs_diff": float(d.double().mean()),
                "lite_moments": _moments(w_lt)}
    del w_bm, w_lt, d
    return {"P": P, "num_draws": num_draws, "out_dtype": str(out_dtype),
            "rows": rows, "split": split, "fidelity": fidelity}


def report(res: Dict) -> str:
    """The probe's printout, as the TPU probe's."""
    n = res["num_draws"]
    lines = [f"numel={res['P']} draws={n} out={res['out_dtype']}"]
    for row in ROWS:
        r = res["rows"][row]
        lines.append(f"{row:7s} t({n})={r['t_n_ms']:8.4f} ms  "
                     f"t(1)={r['t_1_ms']:7.4f} ms  "
                     f"marginal={r['marginal_ms']:7.4f} ms/draw")
    sp = res["split"]
    lines += [f"PRNG+write floor : {sp['prng_write_ms']:7.4f} ms/draw",
              f"BM math (prod)   : {sp['bm_math_prod_ms']:7.4f} ms/draw",
              f"BM math (lite)   : {sp['bm_math_lite_ms']:7.4f} ms/draw",
              f"BM math (fast)   : {sp['bm_math_fast_ms']:7.4f} ms/draw",
              f"lite saves       : {sp['lite_saves_ms']:7.4f} ms/draw",
              f"fast saves       : {sp['fast_saves_ms']:7.4f} ms/draw"]
    fd = res["fidelity"]
    lines.append(f"lite vs prod (f32, 2 draws): max|d|={fd['max_abs_diff']:.3e}"
                 f" mean|d|={fd['mean_abs_diff']:.3e}; lite moments "
                 f"{json.dumps(fd['lite_moments'])}")
    return "\n".join(lines)


def main() -> int:
    res = run()
    print(torch.cuda.get_device_name(0))
    print(report(res))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
