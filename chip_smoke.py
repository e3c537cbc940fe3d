#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failure raises; the script then exits non-zero and prints no
result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Without a CUDA device the script exits non-zero.
2. build: every ``multimodal_auv_torch/csrc/*.cu``, one nvcc each, started
   together.
3. kernels: each kernel against its plain version on the card, bit for bit,
   at a small P with a ragged last block and at the full model's P, chunks
   1, 2 and 3; sampler moments at full P; times of the kernel, the plain
   version, one ``torch.normal`` call over the same work (a yardstick the
   port never calls), and the kernel's bound.
4. main path: a packed set of 10 random 256 px samples (numpy, --seed), the
   full-width model (three ResNet-50 trunks, bf16, 7 classes, MOPED random
   weights), ``multimodal_predict_and_save_packed`` with 20 MC samples at
   batch 4 (a ragged tail of 2). Checks the CSV, that the port on the card
   agrees with the port on the CPU at micro() size, and the kernel launch
   counts of the timed run. ``--profile`` also writes a profiler summary of
   one batch to chiprun_out/chip_smoke/.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
NUM_CLASSES, NUM_MC, BATCH, N_SAMPLES, IMAGE = 7, 20, 4, 10, 256
SMALL_P = 512 * 128 + 1024  # one full block and a partial one
# f32 operations per element pair per draw of the split sampler
# (Box-Muller with the JAX package's polynomials, plus two mu + sigma*eps)
SAMPLER_F32_OPS = {False: 53, True: 41}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from multimodal_auv_torch.ops import kernels

    names = sorted(f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(kernels.build, names)))
    for name, r in results.items():
        ptxas = [ln.strip() for ln in r.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {r.seconds:.1f} s -> {r.path.name}")
        for ln in ptxas:
            log(f"  ptxas {ln}")
    log(f"build total {time.perf_counter() - t0:.1f} s")


def check_sampler(post, n_padded: int):
    """Kernel vs plain version, bit for bit; moments; times. Returns the
    kernels-line entry of the split sampler (launches filled in later)."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.ops import sampling as S

    g = torch.Generator().manual_seed(0)
    small = (torch.randn(SMALL_P, generator=g),
             torch.rand(SMALL_P, generator=g) + 0.01)
    sigma_full = softplus(post.rho.float())
    max_err = 0.0
    for fast, dt in ((False, torch.float32), (True, torch.bfloat16)):
        for label, (mu, sg) in (("small", small), ("full", (post.mu,
                                                             sigma_full))):
            mu, sg = mu.to("cuda", dt).contiguous(), sg.to("cuda", dt).contiguous()
            for n in (1, 2, 3):
                seed = (1234 + n, 5678)
                got = S.gaussian_shift_scale_split(mu, sg, seed, n,
                                                   out_dtype=dt,
                                                   fast_math=fast)
                want = S.split_plain(mu, sg, seed, n, dt, fast)
                torch.cuda.synchronize()
                for x, y in zip(got, want):
                    err = float((x.float() - y.float()).abs().max())
                    max_err = max(max_err, err)
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"split_sampler != plain ({dt}, fast={fast}, "
                            f"{label} P={mu.numel()}, chunk {n}): "
                            f"max abs err {err}")
            log(f"split_sampler == plain bit for bit: {dt}, "
                f"fast_math={fast}, {label} P={mu.numel()}, chunks 1,2,3")

    # moments of eps at full P: mean 0, std 1, draws and blocks uncorrelated
    for fast, dt in ((False, torch.float32), (True, torch.bfloat16)):
        zeros = torch.zeros(n_padded, device="cuda", dtype=dt)
        ones = torch.ones(n_padded, device="cuda", dtype=dt)
        e0, e1 = (w.double() for w in S.gaussian_shift_scale_split(
            zeros, ones, (99, 7), 2, out_dtype=dt, fast_math=fast))
        se = 1.0 / math.sqrt(n_padded)
        blk = S.BLOCK_ELEMS
        corr = lambda a, b: float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        stats = {"mean": float(e0.mean()), "std": float(e0.std()),
                 "corr_draws": corr(e0, e1),
                 "corr_blocks": corr(e0[:blk], e0[blk:2 * blk])}
        log(f"moments {dt} fast={fast}: {json.dumps(stats)}")
        if not (abs(stats["mean"]) < 5 * se
                and abs(stats["std"] - 1) < 10 * se + 2e-3 * fast
                and abs(stats["corr_draws"]) < 5 * se
                and abs(stats["corr_blocks"]) < 5 / math.sqrt(blk)):
            raise AssertionError(f"sampler moments off: {stats}")

    # times at the main path's point: bf16 mu/sigma, bf16 fast, chunk 2
    mu = post.mu.to(torch.bfloat16)
    sg = sigma_full.to(torch.bfloat16)
    P = mu.numel()
    ms = cuda_ms(lambda: S.gaussian_shift_scale_split(
        mu, sg, (1, 2), 2, out_dtype=torch.bfloat16, fast_math=True), 50)
    plain_ms = cuda_ms(lambda: S.split_plain(mu, sg, (1, 2), 2,
                                             torch.bfloat16, True), 3, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu2, sg2 = mu.expand(2, P), sg.expand(2, P)
    library_ms = cuda_ms(lambda: torch.normal(mu2, sg2, generator=gen), 50)
    nbytes = 2 * P * 2 + 2 * P * 2
    ops = (P // 2) * 2 * SAMPLER_F32_OPS[True]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    log(f"split_sampler chunk 2 at P={P}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, torch.normal {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.3f} GB)")
    return {"name": "split_sampler", "route": "cuda",
            "source": "multimodal_auv_torch/csrc/sampling.cu",
            "replaces": "multimodal_auv_tpu/ops/sampling.py:281",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def write_packed(out_dir: str, seed: int) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for key, c in (("main", 3), ("bathy", 3), ("sss", 1)):
        np.save(os.path.join(out_dir, f"{key}.npy"),
                rng.integers(0, 256, (N_SAMPLES, IMAGE, IMAGE, c),
                             dtype=np.uint8))
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump([f"frame_{i:04d}.jpg" for i in range(N_SAMPLES)], f)
    with open(os.path.join(out_dir, "pack_meta.json"), "w") as f:
        json.dump({"size": IMAGE, "fingerprint": f"chip_smoke seed {seed}"}, f)
    return out_dir


def check_csv(path: str) -> None:
    from multimodal_auv_torch.engine.predict import CSV_HEADER

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != CSV_HEADER:
        raise AssertionError(f"CSV header {rows[0]}")
    vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    names = [r[0] for r in rows[1:]]
    if names != [f"frame_{i:04d}.jpg" for i in range(N_SAMPLES)]:
        raise AssertionError(f"CSV names {names}")
    if not np.isfinite(vals).all():
        raise AssertionError("non-finite values in the CSV")
    if not ((vals[:, 0] >= 0) & (vals[:, 0] < NUM_CLASSES)).all():
        raise AssertionError(f"predicted class out of range: {vals[:, 0]}")
    if not ((vals[:, 1] >= 0) & (vals[:, 2] >= 0)
            & (vals[:, 2] <= math.log(NUM_CLASSES) + 1e-4)).all():
        raise AssertionError(f"uncertainties out of range: {vals[:, 1:]}")
    log(f"CSV ok: {len(names)} rows, classes {sorted(set(vals[:, 0]))}, "
        f"aleatoric {vals[:, 2].min():.4f}..{vals[:, 2].max():.4f}")


def check_card_vs_cpu() -> None:
    """The micro() packed step on the card and on the CPU from the same
    seeds: the sampler's draws are bit-equal, the f32 forwards (TF32 off)
    differ only in summation order."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.predict import make_packed_predict_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )

    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    mask = np.array([True, True, False])
    cols = []
    for dev in ("cuda", "cpu"):
        b = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device=dev)
        step = make_packed_predict_step(b, 4)
        out = step(b.post, b.batch_stats,
                   tuple(torch.from_numpy(a).to(dev) for a in u8),
                   torch.Generator().manual_seed(1),
                   torch.from_numpy(mask).to(dev))
        cols.append(out["csv_cols"].cpu().numpy()[:, :2])
    err = float(np.abs(cols[0][1:] - cols[1][1:]).max())
    if not (np.array_equal(cols[0][0], cols[1][0]) and err < 1e-4):
        raise AssertionError(f"card vs CPU at micro(): {cols}")
    log(f"card == CPU at micro(): classes equal, uncertainty max abs err "
        f"{err:.2e}")


def phase_main_path(args, smi: str):
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.predict import (
        make_packed_predict_step,
        multimodal_predict_and_save_packed,
    )
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.ops import kernels

    t0 = time.perf_counter()
    bundle = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                    torch.Generator().manual_seed(args.seed),
                                    ArchConfig(), device="cuda")
    log(f"bundle: P={bundle.meta.n_padded} (real {bundle.meta.n_real}) in "
        f"{time.perf_counter() - t0:.1f} s")

    entry = check_sampler(bundle.post, bundle.meta.n_padded)
    check_card_vs_cpu()

    packed = write_packed(os.path.join(OUT_DIR, "packed"), args.seed)
    csv_path = os.path.join(OUT_DIR, "predictions.csv")
    step = make_packed_predict_step(bundle, NUM_MC)
    run = lambda: multimodal_predict_and_save_packed(
        bundle, packed, csv_path, num_mc_samples=NUM_MC, batch_size=BATCH,
        generator=torch.Generator().manual_seed(args.seed + 1), step=step,
        device="cuda")
    t0 = time.perf_counter()
    run()  # warm-up: cuDNN's algorithm choice, allocator growth
    torch.cuda.synchronize()
    log(f"warm-up run {time.perf_counter() - t0:.2f} s")

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_batches = -(-N_SAMPLES // BATCH)
    log(f"main path: {N_SAMPLES} patches, {n_batches} batches of {BATCH} x "
        f"{NUM_MC} MC in {wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s "
        f"[{smi}]; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    want = n_batches * NUM_MC // 2
    if launches["split_sampler"] != want:
        raise AssertionError(f"split_sampler launched "
                             f"{launches['split_sampler']} times, want {want}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    check_csv(csv_path)
    entry["launches"] = launches["split_sampler"]

    if args.profile:
        profile_batch(bundle, step, args.seed)
    return [entry]


def profile_batch(bundle, step, seed: int) -> None:
    """Device time by kernel over one batch of the main path, and the
    device's busy share (union of kernel intervals over the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    u8 = [torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (BATCH, IMAGE, IMAGE, c), dtype=np.uint8)).cuda()
        for c in (3, 3, 1)]
    mask = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    step(bundle.post, bundle.batch_stats, u8, gen, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(bundle.post, bundle.batch_stats, u8, gen, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy_ms, end = 0.0, -math.inf
    for e in sorted(kern, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        if hi > lo:
            busy_ms += (hi - lo) / 1e3
        end = max(end, hi)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total_ms = sum(t for t, _ in by_name.values())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(f"one batch of {BATCH} x {NUM_MC} MC: wall {wall_ms:.2f} ms, "
                f"kernels {total_ms:.2f} ms in {len(kern)} launches, busy "
                f"{busy_ms:.2f} ms\n")
        for name, (t, c) in rows:
            f.write(f"{t:10.3f} ms {c:7d}  {name}\n")
    log(f"profile (one batch): wall {wall_ms:.2f} ms, kernels "
        f"{total_ms:.2f} ms in {len(kern)} launches, device busy share "
        f"{busy_ms / wall_ms:.3f}; top: " + "; ".join(
            f"{n[:50]} {t:.2f} ms x{c}" for n, (t, c) in rows[:6]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    smi = phase_device()
    sys.path.insert(0, HERE)
    os.makedirs(OUT_DIR, exist_ok=True)
    from multimodal_auv_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off: f32 checks are full f32
    phase_build()
    kernels_line = phase_main_path(args, smi)
    log(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
