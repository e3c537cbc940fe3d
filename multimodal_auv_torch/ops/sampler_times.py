"""Times of the seven sampler kernels at their paths' shapes, and an A/B of
two versions of ``csrc/sampling.cu`` in one process on one card.

    python -m multimodal_auv_torch.ops.sampler_times [--baseline DIR]
        [--out FILE]

``--baseline DIR [DIR ...]``: directories holding other ``sampling.cu``
files with the same C interface, for example a commit's
``multimodal_auv_torch/csrc`` unpacked with ``git archive`` (the first is
named "baseline", the others by their third-last path part). Every source
is built with the package's flags (``ops/kernels.py``) and the runs go
baseline(s), current, current, baseline(s) reversed; without one the
current source runs twice. Each run
first holds every kernel against its plain version, bit for bit, at the
small P's whose last block ends in each quarter (1-3 draws) and at every
timed shape (one launch), then times each case by CUDA events:

* #1 ``split_sampler``: the MC path's point (bf16 in and out, fast noise,
  chunk 2, the full-width posterior's P) and the DVP draw shape (f32,
  20 draws of 2,970,368);
* #2 ``stacked_sampler``: the training point (f32, chunk 1) and the
  antithetic one (bf16 in and out, one draw);
* #3 ``eps`` (f32, chunk 1) and #4 ``reparam_sampler`` (f32, one draw);
* #5-#7 and the eps kernel in bf16 at the RNG-split probe's shape
  (72,941,568 elements): one draw, 20 draws and the marginal ms per draw.

It also counts each library's draw-loop instructions per Box-Muller pair
from its SASS (``ops/sass.py``) and keeps ptxas's register report. Prints
the card's name and power limit, a table of the runs, and writes the JSON
of everything to ``--out`` (``chiprun_out/sampler_times.json``). Raises
without a card, on a build failure and on any difference from a plain
version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from multimodal_auv_torch.ops import kernels, sass
from multimodal_auv_torch.ops import probe_rng_split as PR
from multimodal_auv_torch.ops import sampling as S
from multimodal_auv_torch.ops.probe_rng_split import cuda_ms

# the full-width multimodal posterior's packed size (three ResNet-50
# trunks and the fusion head, 7 classes), the P of the MC and training
# paths
MODEL_P = 73_305_088
DVP_N, DVP_DRAWS = 2_970_368, 20
SMALL_PS = (512 * 128 + 1024, 65536 + 128, 65536 + 16384 + 256,
            65536 + 32768 + 384, 65536 + 49152 + 512)
ITERS, ITERS_MANY = 50, 10


def _inputs(P: int, dtype: torch.dtype, gen: torch.Generator
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = torch.randn(P, device="cuda", generator=gen)
    sg = torch.rand(P, device="cuda", generator=gen) + 0.01
    return mu.to(dtype), sg.to(dtype)


def cases() -> List[Tuple[str, int, Callable, Callable]]:
    """(label, draws, kernel call, plain call) per timed case."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu_b, sg_b = _inputs(MODEL_P, bf16, gen)
    mu_f, sg_f = _inputs(MODEL_P, f32, gen)
    mu_d, sg_d = _inputs(DVP_N, f32, gen)
    rho = torch.rand(MODEL_P, device="cuda", generator=gen) * 55 - 30
    seeds = S.seed_tensor((1, 2), "cuda")
    out = [
        ("#1 split mc (bf16 fast, chunk 2)", 2,
         lambda: S.split_draws(mu_b, sg_b, seeds, 2, out_dtype=bf16,
                               fast_math=True),
         lambda: S.stacked_plain(mu_b, sg_b, (1, 2), 2, bf16, True)),
        (f"#1 split dvp (f32, {DVP_DRAWS} draws)", DVP_DRAWS,
         lambda: S.split_draws(mu_d, sg_d, seeds, DVP_DRAWS, out_dtype=f32),
         lambda: S.stacked_plain(mu_d, sg_d, (1, 2), DVP_DRAWS, f32)),
        ("#2 stacked train (f32, chunk 1)", 1,
         lambda: S.gaussian_shift_scale(mu_f, sg_f, (1, 2), 1),
         lambda: S.stacked_plain(mu_f, sg_f, (1, 2), 1, f32)),
        ("#2 stacked antithetic (bf16, 1 draw)", 1,
         lambda: S.gaussian_shift_scale(mu_b, sg_b, (1, 2), 1,
                                        out_dtype=bf16),
         lambda: S.stacked_plain(mu_b, sg_b, (1, 2), 1, bf16)),
        ("#3 eps train (f32, chunk 1)", 1,
         lambda: S.gaussian_noise(MODEL_P, (1, 2), 1, "cuda"),
         lambda: S.eps_plain(MODEL_P, (1, 2), 1, "cuda")),
        ("#4 reparam (f32, 1 draw)", 1,
         lambda: S.gaussian_reparam(mu_f, rho, (1, 2)),
         lambda: S.reparam_plain(mu_f, rho, (1, 2), 1, f32)[0]),
    ]
    for name, (fn, plain) in PR.LAUNCHED.items():
        for n in (1, PR.PROBE_DRAWS):
            out.append((f"{name} probe (bf16, {n} draws)", n,
                        lambda fn=fn, n=n: fn(PR.PROBE_P, PR.PROBE_SEED, n,
                                              "cuda", bf16),
                        lambda plain=plain, n=n: plain(
                            PR.PROBE_P, PR.PROBE_SEED, n, "cuda", bf16)))
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (-0 apart from +0, NaNs by pattern)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def check_small() -> None:
    """Every kernel against its plain version at the small P's."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    for P in SMALL_PS:
        for dt in (f32, bf16):
            mu, sg = _inputs(P, dt, gen)
            for n in (1, 2, 3):
                seed = (1111 * n + P % 1000, 2222)
                pairs = [
                    (S.split_draws(mu, sg, seed, n, out_dtype=dt),
                     S.stacked_plain(mu, sg, seed, n, dt)),
                    (S.gaussian_shift_scale(mu, sg, seed, n),
                     S.stacked_plain(mu, sg, seed, n, dt)),
                    (S.gaussian_reparam(mu, sg, seed, n),
                     S.reparam_plain(mu, sg, seed, n, dt))]
                if dt == bf16:
                    pairs.append((S.split_draws(mu, sg, seed, n,
                                                out_dtype=dt, fast_math=True),
                                  S.stacked_plain(mu, sg, seed, n, dt, True)))
                for name, (fn, plain) in PR.LAUNCHED.items():
                    if name != "eps_fast" or dt == bf16:
                        pairs.append((fn(P, seed, n, "cuda", dt),
                                      plain(P, seed, n, "cuda", dt)))
                for i, (got, want) in enumerate(pairs):
                    if not same_bits(got, want):
                        raise AssertionError(f"case {i} != plain at P={P}, "
                                             f"{dt}, {n} draws")


def check_parts() -> None:
    """The current library's exact forms against the plain versions on the
    card, bit for bit (-0 and +0 apart), over all 2^24 words and every
    polynomial set."""
    n = 1 << 24
    for noise in S.NOISE_MODES:
        got = S.noise_parts(n, noise, "cuda")
        want = S.noise_parts_plain(n, noise, "cuda")
        for name, a, b in zip(("r", "sin", "cos"), got, want):
            if not same_bits(a, b):
                bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
                raise AssertionError(f"noise_parts {noise} {name}: {bad} "
                                     f"of {n} words differ")
    print(f"noise_parts == plain bit for bit over all {n} words "
          f"({', '.join(S.NOISE_MODES)})", flush=True)


def run_once(label: str, lib: ctypes.CDLL, timed) -> Dict[str, float]:
    kernels._LIBS["sampling"] = lib
    with torch.no_grad():
        check_small()
        for name, _, fn, plain in timed:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"{label}: {name} != plain")
            del got, want
        return {name: cuda_ms(fn, ITERS if n == 1 else ITERS_MANY)
                for name, n, fn, _ in timed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", nargs="+", default=[])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                   "sampler_times.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sampler_times measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    srcs = {"current": kernels.CSRC}
    others = []
    for i, d in enumerate(args.baseline):
        name = "baseline" if i == 0 else Path(d).parts[-3]
        srcs[name] = Path(d)
        others.append(name)
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        builds = dict(zip(srcs, pool.map(
            lambda d: kernels.build("sampling", d), srcs.values())))
    libs, report = {}, {"device": smi, "libraries": {}}
    for k, b in builds.items():
        libs[k] = ctypes.CDLL(str(b.path))
        report["libraries"][k] = {
            "source": str(srcs[k]), "build_s": b.seconds,
            "ptxas": [ln.strip() for ln in b.log.splitlines()
                      if "registers" in ln or "spill" in ln],
            "sass": sass.library_counts(b.path, b.log)}
    kernels._LIBS["sampling"] = libs["current"]
    check_parts()
    order = others + ["current", "current"] + others[::-1]
    timed = cases()
    runs = [(k, run_once(k, libs[k], timed)) for k in order]
    kernels._LIBS.pop("sampling", None)
    report["runs"] = [{"library": k, "ms": ms} for k, ms in runs]
    names = [c[0] for c in timed]
    print(f"{'case':44s} " + " ".join(f"{k:>10s}" for k, _ in runs))
    for n in names:
        print(f"{n:44s} " + " ".join(f"{ms[n]:10.4f}" for _, ms in runs))
    for k in dict.fromkeys(order):
        per = {}
        for name, _ in PR.LAUNCHED.items():
            t1 = [ms[f"{name} probe (bf16, 1 draws)"] for kk, ms in runs
                  if kk == k]
            tn = [ms[f"{name} probe (bf16, {PR.PROBE_DRAWS} draws)"]
                  for kk, ms in runs if kk == k]
            per[name] = [(b - a) / (PR.PROBE_DRAWS - 1)
                         for a, b in zip(t1, tn)]
        report.setdefault("marginal_ms", {})[k] = per
        print(f"{k}: marginal ms per draw at the probe's shape "
              f"{json.dumps(per)}")
        for kern, c in report["libraries"][k]["sass"].items():
            print(f"{k} SASS {kern}: {c['instructions']} instructions / "
                  f"{c['pairs']} pairs = {c['per_pair_total']:.2f} per pair "
                  f"{json.dumps({a: round(b, 2) for a, b in c['per_pair'].items()})}")
        for ln in report["libraries"][k]["ptxas"]:
            print(f"{k} ptxas {ln}")
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
