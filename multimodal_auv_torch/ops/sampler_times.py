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
* #2 ``stacked_sampler``: the training point (f32, chunk 1), per-draw
  remat's chunk (f32, MC_SHARD_DRAWS draws), the
  antithetic one (bf16 in and out, one draw) and the mc-sharded serving
  shard's (``auv::stacked_sampler`` with the seed in device memory,
  MC_SHARD_DRAWS draws of the full P, bf16 in and out); the bf16 cases
  of #2 on a MOPED-like posterior (sigma = 0.1 |mu|, the port's default
  delta) and the shard's also on a stress posterior (sigma = |mu|);
* #3 ``eps`` (f32, chunk 1) and #4 ``reparam_sampler`` (f32, one draw);
* #5-#7 and the eps kernel in bf16 at the RNG-split probe's shape
  (72,941,568 elements): one draw, 20 draws and the marginal ms per draw.

It also counts each library's draw-loop instructions per Box-Muller pair
from its SASS (``ops/sass.py``) and keeps ptxas's register report. The
shard case is also run back to back for ``SUSTAIN_S`` seconds per library
while ``nvidia-smi`` samples the SM clock and the power draw, so a time
can be read beside the clock it ran at. Prints
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
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
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
# the mc-sharded serving shard: NUM_MC / mc_shards draws of the full P
MC_SHARD_DRAWS = 10
SHARD_CASE = "#2 stacked mc shard (bf16, 10 draws, device seed)"
STRESS_CASE = "#2 stacked mc shard stress (bf16, 10 draws, sigma = |mu|)"
ANTI_CASE = "#2 stacked antithetic (bf16, 1 draw, MOPED)"
SMALL_PS = (512 * 128 + 1024, 65536 + 128, 65536 + 16384 + 256,
            65536 + 32768 + 384, 65536 + 49152 + 512)
SMALL_DRAWS = (1, 2, 3, MC_SHARD_DRAWS)
ITERS, ITERS_MANY = 50, 10
SUSTAIN_S = 2.0
# the margin of the bracket constants the bf16 stacked kernel's source holds
BRACKET_MARGIN = 1.5


def _inputs(P: int, dtype: torch.dtype, gen: torch.Generator
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = torch.randn(P, device="cuda", generator=gen)
    sg = torch.rand(P, device="cuda", generator=gen) + 0.01
    return mu.to(dtype), sg.to(dtype)


def posterior(P: int, dtype: torch.dtype, gen: torch.Generator,
              delta: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """A MOPED-like posterior: weight-sized mu and sigma = delta |mu|
    (``BNNPriorSpec``'s default delta 0.1; delta 1 is the stress case of
    the bf16 kernel's exact path), in ``dtype``."""
    mu = (torch.randn(P, device="cuda", generator=gen) * 0.05).to(dtype)
    return mu, (delta * mu.float().abs()).to(dtype)


def cases() -> Tuple[List[Tuple[str, int, Callable, Callable]], Dict]:
    """(label, draws, kernel call, plain call) per timed case, and the
    (mu, sigma, seeds, draws) of each case of the bf16 stacked sampler
    on a MOPED-like or stress posterior."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu_b, sg_b = _inputs(MODEL_P, bf16, gen)
    mu_f, sg_f = _inputs(MODEL_P, f32, gen)
    mu_d, sg_d = _inputs(DVP_N, f32, gen)
    mu_m, sg_m = posterior(MODEL_P, bf16, gen)
    sg_s = mu_m.abs()
    rho = torch.rand(MODEL_P, device="cuda", generator=gen) * 55 - 30
    seeds = S.seed_tensor((1, 2), "cuda")
    n = MC_SHARD_DRAWS  # bound below as a default: the loop rebinds n
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
        ("#2 stacked per-draw remat (f32, 10 draws)", n,
         lambda n=n: S.gaussian_shift_scale(mu_f, sg_f, (1, 2), n),
         lambda n=n: S.stacked_plain(mu_f, sg_f, (1, 2), n, f32)),
        ("#2 stacked antithetic (bf16, 1 draw)", 1,
         lambda: S.gaussian_shift_scale(mu_b, sg_b, (1, 2), 1,
                                        out_dtype=bf16),
         lambda: S.stacked_plain(mu_b, sg_b, (1, 2), 1, bf16)),
        (ANTI_CASE, 1,
         lambda: S.gaussian_shift_scale(mu_m, sg_m, (1, 2), 1,
                                        out_dtype=bf16),
         lambda: S.stacked_plain(mu_m, sg_m, (1, 2), 1, bf16)),
        (SHARD_CASE, n,
         lambda n=n: S.stacked_draws(mu_m, sg_m, seeds, n, out_dtype=bf16),
         lambda n=n: S.stacked_plain(mu_m, sg_m, (1, 2), n, bf16)),
        (STRESS_CASE, n,
         lambda n=n: S.stacked_draws(mu_m, sg_s, seeds, n, out_dtype=bf16),
         lambda n=n: S.stacked_plain(mu_m, sg_s, (1, 2), n, bf16)),
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
    bf16_stacked = {ANTI_CASE: (mu_m, sg_m, seeds, 1),
                    SHARD_CASE: (mu_m, sg_m, seeds, MC_SHARD_DRAWS),
                    STRESS_CASE: (mu_m, sg_s, seeds, MC_SHARD_DRAWS)}
    return out, bf16_stacked


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (-0 apart from +0, NaNs by pattern)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def tie_posterior(mu0: torch.Tensor, seed: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 mu placed so that draw 0 of ``seed`` lands each element on a
    bf16 rounding tie: sigma = |mu0| and mu = t - fl(sigma z), t = mu0
    moved to the tie (low 16 bits 0x8000) and z draw 0's noise; mu +
    sigma z is then within a few f32 steps of t, inside the element's
    bracket (|sigma| E, ~25 steps), so draw 0 takes the exact path in
    nearly every call."""
    sg = mu0.abs()
    z = S.eps_plain(mu0.shape[0], seed, 1, mu0.device)[0]
    tie = ((mu0.view(torch.int32) & ~0xFFFF) | 0x8000).view(torch.float32)
    return tie - sg * z, sg


def stress_inputs(P: int, gen: torch.Generator, seed: Tuple[int, int]
                  ) -> List[Tuple[str, tuple]]:
    """Posteriors on which the bf16 stacked sampler takes its exact path
    often: sigma = |mu| (bf16 and f32 in), and f32 mu on bf16 ties for
    draw 0 of ``seed`` (``tie_posterior``) with exact zeros in mu and
    sigma."""
    mu, _ = posterior(P, torch.float32, gen)
    tie, sg_tie = tie_posterior(mu, seed)
    tie[::97] = 0.0
    sg_tie[::89] = 0.0
    bf = mu.to(torch.bfloat16)
    return [("sigma=|mu| bf16", (bf, bf.abs())),
            ("sigma=|mu| f32", (mu, mu.abs())),
            ("f32 ties", (tie, sg_tie))]


def check_bf16_stacked(P: int, gen: torch.Generator) -> None:
    """The bf16-output stacked sampler against ``stacked_plain`` at P, for
    SMALL_DRAWS draws, bf16 and f32 in, on random and stress inputs; on the
    ties a library with the counted entry must count exact-path calls."""
    bf16 = torch.bfloat16
    counted = hasattr(kernels.load("sampling"), S.COUNTED_ENTRY)
    named = [(f"random {dt}", _inputs(P, dt, gen))
             for dt in (torch.float32, bf16)]
    for n in SMALL_DRAWS:
        seed = (7 * n + P % 977, 0xFFFFFFF0)
        for label, (mu, sg) in named + stress_inputs(P, gen, seed):
            if counted and label == "f32 ties":
                got, calls = S.stacked_exact_calls(mu, sg, seed, n)
                if calls == 0:
                    raise AssertionError(f"no exact-path call at P={P}, "
                                         f"{label}, {n} draws")
            else:
                got = S.stacked_draws(mu, sg, seed, n, out_dtype=bf16)
            if not same_bits(got, S.stacked_plain(mu, sg, seed, n, bf16)):
                raise AssertionError(f"bf16 stacked != plain at P={P}, "
                                     f"{label}, {n} draws")


def check_small() -> None:
    """Every kernel against its plain version at the small P's."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    for P in SMALL_PS:
        check_bf16_stacked(P, gen)
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


def check_bracket(margin: float = BRACKET_MARGIN) -> Dict:
    """The bf16 stacked kernel's approximate radius and angle against the
    contract's over all 2^24 words on the card: the constants they need
    (``bracket_constants`` at ``margin``) and at 1 + 2^-20 (the f32
    evaluation of E), printed, and the library's own constants held to
    the latter: raises where a deviation exceeds its constant."""
    n = 1 << 24
    dev_r, dev_sc, c_max = S.bracket_deviations(
        S.noise_parts(n, "f32", "cuda"), S.approx_parts(n, "cuda"))
    buckets = S.bracket_bucket(torch.arange(n, device="cuda"))
    need_r, need_sc = S.bracket_constants(dev_r, buckets, dev_sc, c_max,
                                          1 + 2.0 ** -20)
    sug_r, sug_sc = S.bracket_constants(dev_r, buckets, dev_sc, c_max, margin)
    have_r, have_sc = S.library_bracket_constants()
    report = {"max_dev_r": float(dev_r.max()), "max_dev_sc": float(
        dev_sc.max()), "c_max": c_max, "need_r": need_r, "need_sc": need_sc,
        f"at_margin_{margin}": [sug_r, sug_sc], "library": [have_r, have_sc]}
    print(f"bracket over all {n} words: max |r' - r| {report['max_dev_r']:.3e}"
          f", max |sin' - sin|, |cos' - cos| {report['max_dev_sc']:.3e}, C "
          f"{c_max!r}; needed E_r {[f'{x:.3e}' for x in need_r]}, E_sc "
          f"{need_sc:.3e}; at margin {margin}: E_r "
          f"{[float(f'{x:.2e}') for x in sug_r]}, E_sc {sug_sc:.2e}; the "
          f"library's E_r {have_r}, E_sc {have_sc}", flush=True)
    short = [i for i, (a, b) in enumerate(zip(need_r, have_r)) if a > b]
    if short or need_sc > have_sc:
        raise AssertionError(f"bracket constants too small: E_r at {short}, "
                             f"E_sc {need_sc} > {have_sc}")
    return report


def sustained(fn) -> Dict:
    """``fn`` back to back for about SUSTAIN_S seconds: ms per call by CUDA
    events, and the median SM clock (MHz) and power draw (W) of the
    samples ``nvidia-smi`` took during the run (every 100 ms)."""
    n = max(10, int(SUSTAIN_S * 1e3 / cuda_ms(fn, 3)))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(1.0)
        t0 = datetime.now()
        ms = cuda_ms(fn, n, warmup=0)
        t1 = datetime.now()
        time.sleep(0.3)
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    clk, watts = [], []
    for ln in out.splitlines():
        parts = [p.strip() for p in ln.split(",")]
        try:
            ts = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
            mhz, w = float(parts[1]), float(parts[2])
        except (ValueError, IndexError):
            continue
        if t0 <= ts <= t1:
            clk.append(mhz)
            watts.append(w)
    return {"ms": ms, "calls": n, "samples": len(clk),
            "sm_mhz": statistics.median(clk) if clk else None,
            "sm_mhz_min": min(clk) if clk else None,
            "watts": statistics.median(watts) if watts else None}


def exact_shares(bf16_stacked: Dict) -> Dict[str, float]:
    """Per case of ``bf16_stacked``: the share of its Philox calls that
    took the bf16 kernel's exact path, by the kernel's own counter."""
    out = {}
    for name, (mu, sg, seeds, n) in bf16_stacked.items():
        _, calls = S.stacked_exact_calls(mu, sg, seeds, n)
        out[name] = calls / S.philox_calls(mu.shape[0], n)
    return out


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
    report["bracket"] = check_bracket()
    order = others + ["current", "current"] + others[::-1]
    timed, bf16_stacked = cases()
    runs = [(k, run_once(k, libs[k], timed)) for k in order]
    shard = next(c for c in timed if c[0] == SHARD_CASE)
    for k in dict.fromkeys(order):
        kernels._LIBS["sampling"] = libs[k]
        with torch.no_grad():
            held = sustained(shard[2])
            if hasattr(libs[k], S.COUNTED_ENTRY):
                held["exact_share"] = exact_shares(bf16_stacked)
        report.setdefault("sustained", {})[k] = held
        print(f"{k}: {SHARD_CASE} back to back x {held['calls']}: "
              f"{held['ms']:.4f} ms a call at SM {held['sm_mhz']} MHz "
              f"(min {held['sm_mhz_min']}, {held['samples']} samples), "
              f"{held['watts']} W [{smi}]; exact-path share of Philox "
              f"calls {json.dumps(held.get('exact_share'))}", flush=True)
    kernels._LIBS.pop("sampling", None)
    report["runs"] = [{"library": k, "ms": ms} for k, ms in runs]
    names = [c[0] for c in timed]
    width = max(map(len, names))
    print(f"{'case':{width}s} " + " ".join(f"{k:>10s}" for k, _ in runs))
    for n in names:
        print(f"{n:{width}s} " + " ".join(f"{ms[n]:10.4f}" for _, ms in runs))
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
