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
   at small P's whose last block ends in each of its four quarters and at
   the full model's P, chunks
   1, 2 and 3; sampler moments at full P; times of the kernel, the plain
   version, one ``torch.normal`` call over the same work (a yardstick the
   port never calls), and the kernel's bound.
4. inference path: a packed set of 10 random 256 px samples (numpy,
   --seed), the full-width model (three ResNet-50 trunks, bf16, 7 classes,
   MOPED random weights), ``multimodal_predict_and_save_packed`` with 20 MC
   samples at batch 4 (a ragged tail of 2). Checks the CSV, that the port
   on the card agrees with the port on the CPU at micro() size, and the
   kernel launch counts of the timed run: 30 split_sampler, no other.
5. training kernels: the stacked sampler and the eps kernel against their
   plain versions bit for bit (the small P's and full P, chunks 1, 2, 3,
   f32 and bf16 outputs); eps kernel == stacked at (0, 1) == split (f32
   noise) at (0, 1); eps moments at full P; times beside the bound, the
   plain version and one library call (``torch.normal`` over the expanded
   (n, P) mu and sigma; ``torch.randn``); the autograd backward on the
   card against autograd through the plain version (1e-6 relative).
6. training, card vs CPU: one micro() train step from the same seeds on
   both; loss and CE to 1e-4 relative, mu and rho gradients to 2e-2 with
   a leaf-scaled floor, new running statistics to 1e-5.
7. training path: a survey tree of 20 sample folders of random 256 px
   images over 7 classes (PIL, --seed); one epoch of
   ``run_AUV_training_from_scratch`` on the card (folder scan, decode into
   the packed cache, split 16 / 4) at batch 12 x 20 MC, chunks of 1, remat
   on, f32 posterior, full width: 2 train steps (a ragged tail of 4) and
   one padded eval batch. Checks that it returns True, the saved train
   state's epoch and step count, that mu, rho and the running statistics
   moved, both ledgers, the run manifest, the posterior checkpoint, and
   the launch counts of the epoch: 80 stacked_sampler (forward and
   re-forward), 40 eps, 20 split_sampler. Prints the time of each train
   step (the smoke wraps the step the pipeline builds), samples per
   second and peak memory.

8. kernel #4 (the reparam sampler, softplus inside) against its plain
   version bit for bit: the small P's and the full multimodal P, 1, 2
   and 3 draws, f32 and bf16 in and out, rho over [-30, 25] so both
   branches of softplus_k run; its eps == the eps kernel's (mu = 0,
   rho = 32: w / 32 bit for bit); moments at full P; the wrapper refuses
   inputs that require grad; times of the kernel, the plain version, one
   ``torch.normal(mu, std)`` with std precomputed, and the byte bound.
9. ``define_models(7, BNNPriorSpec(), gen, ArchConfig())`` on the card at
   full width (three unimodal ResNet-50 classifiers, the multimodal model,
   three feature trunks; bf16, 256 px): each Bayesian bundle's P, one
   ``sample_and_apply(mutable=True)`` per Bayesian bundle at batch 4
   (finite (4, 7) logits, running statistics that moved), ``apply_mean``,
   the trunks' features; exactly 4 reparam_sampler launches, no other;
   one micro() ``sample_and_apply`` card == CPU.
10. unimodal inference (BASELINE.json configs[0]): a 10-folder inference
    tree of random 256 px images (PIL), ``prepare_inference_dataloader``
    at batch 4 and ``unimodal_predict_and_save`` (optical image, 10 MC) on
    the full-width image bundle: the CSV, patches per second, exactly 30
    stacked_sampler launches (3 batches x 10 draws, chunk 1), no other.
11. unimodal training (BASELINE.json configs[1]): the survey-tree writer
    of phase 7, ``run_unimodal_training(model_type="sss", num_epochs=2,
    num_mc=5, batch_size=8, device=None)``: epoch 0 is skipped, so one
    epoch of 4 train steps (a ragged tail of 1) and one eval batch padded
    to 8; its ledgers, manifest, confusion-matrix PNG (where matplotlib
    is installed), that mu, rho and the running statistics moved; exactly 40 stacked_sampler (forward and
    re-forward), 20 eps and 5 split_sampler launches; seconds per step,
    samples per second, peak memory.

12. the RNG-split probe (``python -m multimodal_auv_torch.ops.probe_rng_split``,
    the port of scripts/probe_rng_split.py): every kernel it launches
    (rng_bits, rng_bmlite, eps_fast, and the eps kernel in f32 and bf16)
    against its plain version bit for bit at the small and quarter-ending
    P's, the full P, and the probe's own shapes (72,941,568 elements x 20
    draws bf16, and x 2 draws f32 for the fidelity check); then its run
    at that geometry (the TPU probe's): the marginal ms per draw of bits,
    bm (the eps kernel), bmlite and bmfast, the split into "PRNG +
    write" and "Box-Muller math", lite against the f32 polynomials on the
    same bits (max and mean |d|, moments), with exact launch counts; each
    probe kernel's time at one draw beside its plain version,
    ``torch.randn`` and its bound.

13. pretrained inference: a full-width source bundle (perturbed mu and
    rho) written by ``save_torch_checkpoint`` in the published form
    (``module.``, ``*_model_feat.model.``, zero-filled bayesian-torch
    buffers: the 1,740 keys of ``expected_hf_keys.json``), imported by
    ``load_and_prepare_multimodal_model`` into a bundle of another seed:
    mu, rho, det and batch_stats bit-equal, stats loaded / ignored equal
    to the inventory's, nothing dropped, missing or unexpected; times of
    the write, the ``torch.load`` and the import. Then the inference CLI
    in-process (``--model_weights``, ``--packed_loader``, phase 10's tree,
    b4 x 20 MC, chunk 2): exit 0, exactly 30 split_sampler launches, a CSV
    byte-equal to the source bundle's through
    ``multimodal_predict_and_save_packed``; then ``define_models`` with a
    full-width torchvision-named ResNet-50 file for all three trunks:
    conv1 mu == the file's, sigma == 0.1 |w|, the sss conv1 keeps its
    random init, no launches.
14. frozen-backbone retraining (BASELINE.json configs[3]): the retrain CLI
    in-process from phase 13's 7-class file, ``--num_classes 4`` (the fc2
    head swapped: 4 keys dropped), ``--freeze_backbone``, one epoch at b12
    x 20 MC (chunk 1, remat on, f32) over a 32-folder tree of 4 classes,
    with a resume checkpoint: exit 0, ledgers and manifest, the trunks'
    mu and rho and every BN affine leaf bit-equal to the imported ones
    with zero Adam moments, the head and the running statistics moved;
    exactly 120 stacked_sampler, 60 eps and 20 split_sampler launches;
    seconds per step, samples per second, peak memory.

The kernels line's launches of #1-#3 add phases 13 and 14 to their paths'
counts. Beside each sampler's bound the script prints the noise contract's Philox
calls for that launch and their estimated INT32 time, labelled as an
estimate; it is not part of ``bound_ms``.

``--profile`` also writes profiler summaries of one inference batch and of
one train step to chiprun_out/chip_smoke/. Launch counts are reset at the
start of each counted run, and each phase expects exactly its own kernels.
Before them it prints the script's own wall time. The line before the
last is the kernels' JSON; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
NUM_CLASSES, NUM_MC, BATCH, N_SAMPLES, IMAGE = 7, 20, 4, 10, 256
TRAIN_BATCH, TRAIN_SAMPLES = 12, 32  # the reference's b12 x 20 MC
# phase 7's tree: two train steps (phase 14 runs the three-step epoch of
# TRAIN_SAMPLES folders through the same loops)
SCRATCH_SAMPLES = 20
SMALL_P = 512 * 128 + 1024  # one full block and a partial one
# P's whose last block ends inside its first, second, third, fourth quarter
QUARTER_PS = (65536 + 128, 65536 + 16384 + 256, 65536 + 32768 + 384,
              65536 + 49152 + 512)
SMALL_PS = (SMALL_P,) + QUARTER_PS
# f32 operations per element pair per draw of the split sampler
# (Box-Muller with the JAX package's polynomials, plus two mu + sigma*eps)
SAMPLER_F32_OPS = {False: 53, True: 41}
EPS_F32_OPS = SAMPLER_F32_OPS[False] - 4  # the noise alone
# the reparam sampler adds softplus_k per element: a compare, libdevice's
# expf and log1pf, counted as 30 f32 operations (an estimate)
REPARAM_F32_OPS = SAMPLER_F32_OPS[False] + 2 * 30
# the RNG-split probe's kernels, per pair per draw: the 2-term ln drops one
# multiply-add of the bf16-budget noise; rng_bits only converts two words
PROBE_F32_OPS = {"rng_bits": 2, "rng_bmlite": SAMPLER_F32_OPS[True] - 6,
                 "eps_fast": SAMPLER_F32_OPS[True] - 4}
# An estimate, not a bound: Philox-4x32-10 costs ~60 INT32 operations per
# call (10 rounds of two 32x32->64 multiplies, counted as four, and two
# three-input xors), and an H100 SXM issues 64 INT32 operations per SM per
# clock (CUDA C++ Programming Guide, arithmetic throughput, compute
# capability 9.0): 132 SMs x 64 x 1.98 GHz boost.
PHILOX_INT32_OPS = 60
INT32_OPS_PER_S = 132 * 64 * 1.98e9
UNI_MC, UNI_BATCH, UNI_CLASSES = 10, 4, 7      # BASELINE.json configs[0]
UNI_TRAIN_MC, UNI_TRAIN_BATCH = 5, 8           # BASELINE.json configs[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    from multimodal_auv_torch.ops import kernels

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def check_launches(phase: str, want: dict) -> dict:
    """The launch counts since the last reset must be exactly ``want``
    (every kernel not named there: 0)."""
    from multimodal_auv_torch.ops import kernels

    got = dict(kernels.LAUNCHES)
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{phase}: kernel launches {got}, want {full}")
    return got


def bound_ms(nbytes: float, ops: float):
    """(bound in ms, "bytes" or "operations") on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def philox_calls(P: int, num_draws: int) -> int:
    """The noise contract's Philox calls for one launch over P elements and
    ``num_draws`` draws: one per call j whose element j lies inside P."""
    from multimodal_auv_torch.ops import sampling as S

    full, rem = divmod(P, S.BLOCK_ELEMS)
    return num_draws * (full * S.CALLS_PER_BLOCK
                        + min(rem, S.CALLS_PER_BLOCK))


def philox_note(P: int, num_draws: int) -> str:
    """The contract's Philox calls for one launch and their INT32 time,
    labelled as the estimate it is (never folded into bound_ms)."""
    calls = philox_calls(P, num_draws)
    ms = calls * PHILOX_INT32_OPS / INT32_OPS_PER_S * 1e3
    return (f"Philox estimate (not a bound): {calls} calls x "
            f"{PHILOX_INT32_OPS} INT32 ops at {INT32_OPS_PER_S / 1e12:.2f} "
            f"TOP/s = {ms:.4f} ms")


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
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import sampling as S

    g = torch.Generator().manual_seed(0)
    cases = [("small", (torch.randn(P, generator=g),
                               torch.rand(P, generator=g) + 0.01))
             for P in SMALL_PS]
    sigma_full = softplus(post.rho.float())
    cases.append(("full", (post.mu, sigma_full)))
    max_err = 0.0
    for fast, dt in ((False, torch.float32), (True, torch.bfloat16)):
        for label, (mu, sg) in cases:
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
                                             torch.bfloat16, True), 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu2, sg2 = mu.expand(2, P), sg.expand(2, P)
    library_ms = cuda_ms(lambda: torch.normal(mu2, sg2, generator=gen), 50)
    nbytes = 2 * P * 2 + 2 * P * 2
    ops = (P // 2) * 2 * SAMPLER_F32_OPS[True]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    log(f"split_sampler chunk 2 at P={P}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, torch.normal {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.3f} GB); "
        f"{philox_note(P, 2)}")
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


def phase_main_path(args, smi: str, work: str):
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

    packed = write_packed(os.path.join(work, "packed"), args.seed)
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

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batches = -(-N_SAMPLES // BATCH)
    launches = check_launches("inference path",
                              {"split_sampler": n_batches * NUM_MC // 2})
    log(f"main path: {N_SAMPLES} patches, {n_batches} batches of {BATCH} x "
        f"{NUM_MC} MC in {wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s "
        f"[{smi}]; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    check_csv(csv_path)
    entry["launches"] = launches["split_sampler"]

    if args.profile:
        profile_batch(bundle, step, args.seed)
    return bundle, entry


def profile_batch(bundle, step, seed: int) -> None:
    """Device time by kernel over one batch of the inference path."""
    u8 = [torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (BATCH, IMAGE, IMAGE, c), dtype=np.uint8)).cuda()
        for c in (3, 3, 1)]
    mask = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    profile_run(f"one batch of {BATCH} x {NUM_MC} MC", "profile.txt",
                lambda: step(bundle.post, bundle.batch_stats, u8, gen, mask))


def profile_run(label: str, filename: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (after one unprofiled
    call), and the device's busy share (union of kernel intervals over the
    wall time), written to chiprun_out/chip_smoke/<filename>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    with open(os.path.join(OUT_DIR, filename), "w") as f:
        f.write(f"{label}: wall {wall_ms:.2f} ms, kernels {total_ms:.2f} ms "
                f"in {len(kern)} launches, busy {busy_ms:.2f} ms\n")
        for name, (t, c) in rows:
            f.write(f"{t:10.3f} ms {c:7d}  {name}\n")
    log(f"profile ({label}): wall {wall_ms:.2f} ms, kernels "
        f"{total_ms:.2f} ms in {len(kern)} launches, device busy share "
        f"{busy_ms / wall_ms:.3f}; top: " + "; ".join(
            f"{n[:50]} {t:.2f} ms x{c}" for n, (t, c) in rows[:6]))


def check_train_kernels(post, n_padded: int):
    """Kernels #2 (stacked sampler) and #3 (eps) against their plain
    versions and each other's noise; eps moments; the backward; times.
    Returns their kernels-line entries (launches filled in later)."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import sampling as S

    g = torch.Generator().manual_seed(1)
    cases = [("small", (torch.randn(P, generator=g).cuda(),
                        (torch.rand(P, generator=g) + 0.01).cuda()))
             for P in SMALL_PS]
    small = cases[0][1]
    with torch.no_grad():
        full = (post.mu.detach(), softplus(post.rho.detach().float()))
    cases.append(("full", full))
    err = {"stacked_sampler": 0.0, "eps": 0.0}
    for label, (mu, sg) in cases:
        P = mu.numel()
        for n in (1, 2, 3):
            seed = (4321 + n, 8765)
            for dt in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    got = S.gaussian_shift_scale(mu, sg, seed, n, out_dtype=dt)
                want = S.stacked_plain(mu, sg, seed, n, dt)
                torch.cuda.synchronize()
                err["stacked_sampler"] = max(err["stacked_sampler"], float(
                    (got.float() - want.float()).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"stacked_sampler != plain ({dt}, "
                                         f"{label} P={P}, chunk {n})")
                del got, want
            eps = S.gaussian_noise(P, seed, n, "cuda")
            want = S.eps_plain(P, seed, n, "cuda")
            torch.cuda.synchronize()
            err["eps"] = max(err["eps"], float((eps - want).abs().max()))
            if not torch.equal(eps, want):
                raise AssertionError(f"eps != plain ({label} P={P}, chunk {n})")
            zeros = torch.zeros(P, device="cuda")
            ones = torch.ones(P, device="cuda")
            with torch.no_grad():
                at01 = S.gaussian_shift_scale(zeros, ones, seed, n)
            split = S.gaussian_shift_scale_split(zeros, ones, seed, n)
            if not (torch.equal(at01, eps)
                    and all(torch.equal(a, b) for a, b in zip(split, eps))):
                raise AssertionError(f"the three kernels' noise differs "
                                     f"({label} P={P}, chunk {n})")
            del eps, want, at01, split, zeros, ones
        log(f"stacked_sampler, eps == plain bit for bit, eps == stacked(0, 1) "
            f"== split f32 (0, 1): {label} P={P}, chunks 1,2,3, f32 and bf16")

    P = n_padded
    e0, e1 = (e.double() for e in S.gaussian_noise(P, (77, 5), 2, "cuda"))
    se = 1.0 / math.sqrt(P)
    blk = S.BLOCK_ELEMS
    corr = lambda a, b: float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    stats = {"mean": float(e0.mean()), "std": float(e0.std()),
             "corr_draws": corr(e0, e1),
             "corr_blocks": corr(e0[:blk], e0[blk:2 * blk])}
    del e0, e1
    log(f"eps moments at P={P}: {json.dumps(stats)}")
    if not (abs(stats["mean"]) < 5 * se and abs(stats["std"] - 1) < 10 * se
            and abs(stats["corr_draws"]) < 5 * se
            and abs(stats["corr_blocks"]) < 5 / math.sqrt(blk)):
        raise AssertionError(f"eps moments off: {stats}")

    # the backward on the card against autograd through the plain version
    mu = small[0].clone().requires_grad_()
    sg = small[1].clone().requires_grad_()
    cot = torch.randn(3, SMALL_P, generator=g).cuda()
    got = torch.autograd.grad(S.gaussian_shift_scale(mu, sg, (9, 4), 3),
                              (mu, sg), cot)
    want = torch.autograd.grad(mu + sg * S.eps_plain(SMALL_P, (9, 4), 3,
                                                     "cuda"), (mu, sg), cot)
    for name, a, b in zip(("dmu", "dsigma"), got, want):
        rel = float((a - b).abs().max() / b.abs().max())
        if rel > 1e-6:
            raise AssertionError(f"backward {name} off the plain autograd: "
                                 f"{rel:.2e} relative")
        log(f"backward {name} on the card == plain autograd: max error "
            f"{rel:.2e} relative (3 draws, P={SMALL_P})")

    # times at the training path's point: f32 mu and sigma, f32 out, chunk 1
    mu, sg = full
    n = 1
    ms = cuda_ms(lambda: S.gaussian_shift_scale(mu, sg, (1, 2), n), 50)
    plain_ms = cuda_ms(lambda: S.stacked_plain(mu, sg, (1, 2), n,
                                               torch.float32), 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mun, sgn = mu.expand(n, P), sg.expand(n, P)
    lib_ms = cuda_ms(lambda: torch.normal(mun, sgn, generator=gen), 50)
    b_ms, b_by = bound_ms(2 * P * 4 + n * P * 4,
                          (P // 2) * n * SAMPLER_F32_OPS[False])
    log(f"stacked_sampler chunk 1 f32 at P={P}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, torch.normal {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); {philox_note(P, n)}")
    entries = [{"name": "stacked_sampler", "route": "cuda",
                "source": "multimodal_auv_torch/csrc/sampling.cu",
                "replaces": "multimodal_auv_tpu/ops/sampling.py:198",
                "launches": None, "max_abs_err": err["stacked_sampler"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}]
    ms = cuda_ms(lambda: S.gaussian_noise(P, (1, 2), n, "cuda"), 50)
    plain_ms = cuda_ms(lambda: S.eps_plain(P, (1, 2), n, "cuda"), 3)
    lib_ms = cuda_ms(lambda: torch.randn(n, P, device="cuda", generator=gen),
                     50)
    b_ms, b_by = bound_ms(n * P * 4, (P // 2) * n * EPS_F32_OPS)
    log(f"eps chunk 1 at P={P}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"torch.randn {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{philox_note(P, n)}")
    entries.append({"name": "eps", "route": "cuda",
                    "source": "multimodal_auv_torch/csrc/sampling.cu",
                    "replaces": "multimodal_auv_tpu/ops/sampling.py:213",
                    "launches": None, "max_abs_err": err["eps"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms})
    return entries


def _leaf_close(got, want, name, rtol=2e-2, floor_frac=1e-3) -> None:
    """tests/test_train_parity.py's criterion: elementwise rtol with a
    floor of floor_frac * max|want|."""
    scale = max(float(want.abs().max()), 1e-12)
    bad = (got - want).abs() > rtol * want.abs() + floor_frac * scale
    if bool(bad.any()):
        raise AssertionError(f"card vs CPU gradient {name}: "
                             f"{int(bad.sum())} elements off")


def check_train_card_vs_cpu() -> None:
    """One micro() train step on the card and on the CPU from the same
    seeds: the kernels' eps equal the plain versions', so the two differ
    only in the f32 forwards' summation order (TF32 off)."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
    from multimodal_auv_torch.engine.steps import make_train_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )

    rng = np.random.default_rng(2)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    labels, mask = np.array([1, 4, 6]), np.array([1.0, 1.0, 0.0], np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        b = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device=dev)
        state = BayesTrainState(b.post, make_optimizer(1e-3, 1e-5).init(b.post),
                                b.batch_stats)
        step = make_train_step(b.module, b.meta, BNNPriorSpec(), 3,
                               packed_inputs=True)
        state, m = step(state, [torch.from_numpy(a).to(dev) for a in u8],
                        torch.from_numpy(labels).to(dev),
                        torch.from_numpy(mask).to(dev),
                        torch.Generator().manual_seed(3), 1e-6, 3.0)
        stats = {p: t.cpu() for p, t in _walk(state.batch_stats)}
        out.append({"loss": float(m["loss"]),
                    "ce": float(m["cross_entropy"]),
                    "gmu": b.post.mu.grad.cpu(), "grho": b.post.rho.grad.cpu(),
                    "entries": b.meta.entries, "stats": stats})
    card, cpu = out
    for k in ("loss", "ce"):
        if abs(card[k] - cpu[k]) > 1e-4 * abs(cpu[k]):
            raise AssertionError(f"card vs CPU {k}: {card[k]} vs {cpu[k]}")
    for e in cpu["entries"]:
        sl = slice(e.offset, e.offset + e.size)
        for g in ("gmu", "grho"):
            _leaf_close(card[g][sl], cpu[g][sl], f"{g}{e.path}")
    err = max(float((card["stats"][k] - v).abs().max())
              for k, v in cpu["stats"].items())
    if err > 1e-5:
        raise AssertionError(f"card vs CPU running statistics: {err:.2e}")
    log(f"train step card == CPU at micro(): loss {card['loss']:.6f} vs "
        f"{cpu['loss']:.6f}, CE {card['ce']:.6f} vs {cpu['ce']:.6f}, "
        f"gradients within 2e-2 + leaf floor, statistics max error "
        f"{err:.2e}")


def write_training_tree(root: str, seed: int,
                        num_classes: int = NUM_CLASSES,
                        n_samples: int = TRAIN_SAMPLES) -> str:
    """A labelled survey tree that ``MultimodalFolderDataset`` accepts:
    ``n_samples`` sample folders of random 256 px images (main frame, SSS,
    combined bathymetry, 10 m and 30 m patches of both) over the first
    ``num_classes`` habitat classes, made from ``seed``."""
    from PIL import Image

    from multimodal_auv_torch.config import HABITAT_CLASSES

    rng = np.random.default_rng(seed + 100)
    labels = rng.permutation(np.arange(n_samples) % num_classes)
    img = lambda c: Image.fromarray(np.squeeze(rng.integers(
        0, 256, (IMAGE, IMAGE, c), dtype=np.uint8)))
    for i, lab in enumerate(labels):
        d = os.path.join(root, f"sample_{i:03d}")
        os.makedirs(d)
        img(3).save(os.path.join(d, f"frame_{i:04d}.jpg"))
        img(1).save(os.path.join(d, f"survey_SSS_{i}.png"))
        img(3).save(os.path.join(d, "combined_rgb_bathymetry.jpg"))
        for ps in ("10m", "30m"):
            img(3).save(os.path.join(d, f"patch_{ps}_combined_bathy.png"))
            img(1).save(os.path.join(d, f"patch_{ps}_survey_SSS.png"))
        with open(os.path.join(d, f"{HABITAT_CLASSES[lab]}.txt"), "w") as f:
            f.write(HABITAT_CLASSES[lab])
        with open(os.path.join(d, "normalised_meta.csv"), "w") as f:
            f.write("easting,northing\n1,2\n")
    return root


def check_training_outputs(root: str, model_type: str, st: dict) -> None:
    """One multimodal training epoch's outputs under ``root``: both CSV
    ledgers (one finite row each), a run manifest that names the card, and
    the posterior checkpoint ``model_type``, equal to the saved train
    state ``st``."""
    from multimodal_auv_torch.engine import checkpointing as ckpt
    from multimodal_auv_torch.engine.loops import (
        EVAL_CSV_HEADER,
        TRAIN_CSV_HEADER,
    )

    csv_dir = os.path.join(root, "csvs")
    for name, head in (("multimodal_train_results.csv", TRAIN_CSV_HEADER),
                       ("multimodal_eval_results.csv", EVAL_CSV_HEADER)):
        with open(os.path.join(csv_dir, name), newline="") as f:
            rows = list(csv.reader(f))
        if rows[0] != head or len(rows) != 2:
            raise AssertionError(f"{name}: {rows}")
        vals = [float(v) for v in rows[1][2:-2]]  # up to the patch types
        if not np.isfinite(vals).all():
            raise AssertionError(f"{name}: non-finite values {rows[1]}")
        log(f"{name}: {rows[1]}")
    with open(os.path.join(csv_dir, "run_manifest.json")) as f:
        platform = json.load(f)["devices"]["platform"]
    if platform != "cuda":
        raise AssertionError(f"run manifest platform {platform!r}")
    path = ckpt.model_checkpoint_path(
        os.path.join(csv_dir, "multimodal_train_results.csv"), model_type)
    post = ckpt.load_posterior(path)
    if not (torch.equal(post.mu, st["post"]["mu"])
            and torch.equal(post.rho, st["post"]["rho"])):
        raise AssertionError("the posterior checkpoint differs from the "
                             "train state")
    log(f"posterior checkpoint {os.path.relpath(path, root)} and run "
        f"manifest ok")


@contextlib.contextmanager
def timed_train_steps(pipeline):
    """While open, every train step that ``pipeline`` (a pipelines module)
    builds is timed on the host clock, ending in a synchronize; yields
    (times, steps): the seconds of each call and the steps as built."""
    times, steps = [], []
    build = pipeline.make_train_step

    def timed_build(*a, **kw):
        step = build(*a, **kw)
        steps.append(step)

        def timed_step(*sa):
            t0 = time.perf_counter()
            out = step(*sa)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return timed_step

    pipeline.make_train_step = timed_build
    try:
        yield times, steps
    finally:
        pipeline.make_train_step = build


def phase_training(args, smi: str, bundle, work: str):
    """The training path at full width: kernels, card vs CPU, then one
    epoch through ``run_AUV_training_from_scratch`` on a folder tree in
    ``work``. ``bundle`` is the inference phase's model, built from the
    same seed as the pipeline's: the posterior before training."""
    from multimodal_auv_torch.data.loaders import split_indices
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.pipelines import training as pipeline

    entries = check_train_kernels(bundle.post, bundle.meta.n_padded)
    check_train_card_vs_cpu()

    root = write_training_tree(os.path.join(work, "tree"), args.seed,
                               n_samples=SCRATCH_SAMPLES)
    state_path = os.path.join(work, "train_state.pt")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the pipeline logs under ./logs and ./tensorboard_logs
    with timed_train_steps(pipeline) as (times, steps), \
            contextlib.chdir(work):
        ok = pipeline.run_AUV_training_from_scratch(
            {}, 1e-5, 1, NUM_MC, "10m", "30m", TRAIN_BATCH, root,
            arch=ArchConfig(), mc_chunk=1, seed=args.seed,
            use_packed_loader=True, strict_errors=True,
            resume_checkpoint=state_path, remat="on")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"run_AUV_training_from_scratch returned {ok}")
    train_idx, test_idx = split_indices(SCRATCH_SAMPLES)
    n_steps = -(-len(train_idx) // TRAIN_BATCH)
    launches = check_launches("training path", {
        "stacked_sampler": n_steps * NUM_MC * 2, "eps": n_steps * NUM_MC,
        "split_sampler": -(-len(test_idx) // TRAIN_BATCH) * NUM_MC})
    peak = torch.cuda.max_memory_allocated() / 2**30
    later = times[1:]
    per_step = sum(later) / len(later)
    log(f"training path: run_AUV_training_from_scratch, 1 epoch over "
        f"{SCRATCH_SAMPLES} folders (scan, decode and pack included), "
        f"{len(train_idx)} train samples in {n_steps} steps of {TRAIN_BATCH} "
        f"x {NUM_MC} MC (chunk 1, remat on, f32 posterior) and "
        f"{len(test_idx)} eval samples, in {wall:.2f} s [{smi}]; steps "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {per_step:.3f} s per "
        f"step after the first = {TRAIN_BATCH / per_step:.3f} samples/s; "
        f"peak memory {peak:.2f} GiB; launches {launches}")

    saved = torch.load(state_path, map_location="cpu", weights_only=True)
    st = saved["state"]
    if saved["epoch"] != 1 or st["step"] != n_steps:
        raise AssertionError(f"train state at epoch {saved['epoch']}, step "
                             f"{st['step']}; want 1, {n_steps}")
    # Adam at lr 1e-5 moves each element by about 1e-5 per step: a small
    # nonzero change shows the pipeline's model started from ``bundle``'s
    # weights and trained
    for k in ("mu", "rho"):
        d = float((st["post"][k] - getattr(bundle.post, k).detach().cpu())
                  .abs().max())
        if not 0 < d < 1e-3:
            raise AssertionError(f"{k} moved by {d:.3e}, want (0, 1e-3)")
    var = lambda bs: bs["image_model_feat"]["bn1"]["var"].cpu()
    if torch.equal(var(st["batch_stats"]), var(bundle.batch_stats)):
        raise AssertionError("the running statistics did not move")
    check_training_outputs(root, "multimodal_bathy_patch10m_sss_patch30m",
                           st)
    log(f"train state (epoch 1, step {n_steps}) ok")
    del saved, st
    for e in entries:
        e["launches"] = launches[e["name"]]

    if args.profile:
        from multimodal_auv_torch.engine.optim import (
            BayesTrainState,
            make_optimizer,
        )

        rng = np.random.default_rng(args.seed + 7)
        inputs = [torch.from_numpy(rng.integers(
            0, 256, (TRAIN_BATCH, IMAGE, IMAGE, c), dtype=np.uint8)).cuda()
            for c in (3, 3, 1)]
        labels = torch.from_numpy(
            rng.integers(0, NUM_CLASSES, TRAIN_BATCH)).cuda()
        mask = torch.ones(TRAIN_BATCH, device="cuda")
        gen = torch.Generator().manual_seed(args.seed + 7)
        box = [BayesTrainState(bundle.post,
                               make_optimizer(1e-5, 1e-5).init(bundle.post),
                               bundle.batch_stats)]

        def one_step():
            box[0], _ = steps[0](box[0], inputs, labels, mask, gen, 1.0,
                                 float(TRAIN_BATCH))

        profile_run(f"one train step of {TRAIN_BATCH} x {NUM_MC} MC",
                    "profile_train.txt", one_step)
    return entries


def check_reparam_kernel(P_full: int):
    """Phase 8: kernel #4 against its plain version and the eps kernel;
    moments; grad refusal; times. Returns its kernels-line entry
    (launches filled in by phase 9)."""
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import sampling as S

    g = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    max_err = 0.0
    for label, P in [("small", p) for p in SMALL_PS] + [("full", P_full)]:
        mu32 = torch.randn(P, device="cuda", generator=g)
        rho32 = torch.rand(P, device="cuda", generator=g) * 55 - 30
        for in_dt in (f32, bf16):
            mu, rho = mu32.to(in_dt), rho32.to(in_dt)
            for out_dt in (f32, bf16):
                for n in (1, 2, 3):
                    seed = (2468 + n, 1357)
                    got = S.gaussian_reparam(mu, rho, seed, n,
                                             out_dtype=out_dt)
                    want = S.reparam_plain(mu, rho, seed, n, out_dt)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    max_err = max(max_err, err)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"reparam_sampler != plain (in {in_dt}, out "
                            f"{out_dt}, {label} P={P}, {n} draws): max abs "
                            f"err {err}")
                    del got, want
        zeros = torch.zeros(P, device="cuda")
        rho_big = torch.full((P,), 32.0, device="cuda")
        for n in (1, 2, 3):
            w = S.gaussian_reparam(zeros, rho_big, (97, n), n)
            eps = S.gaussian_noise(P, (97, n), n, "cuda")
            if not torch.equal(w / 32.0, eps):
                raise AssertionError(f"reparam_sampler's eps != the eps "
                                     f"kernel's ({label} P={P}, {n} draws)")
            del w, eps
        log(f"reparam_sampler == plain bit for bit: {label} P={P}, 1,2,3 "
            f"draws, f32 and bf16 in and out, rho in [-30, 25]; eps == eps "
            f"kernel (mu 0, rho 32)")
        del mu32, rho32, mu, rho, zeros, rho_big

    # moments at full P: mu 0.5, rho 0, so sigma = softplus(0) = ln 2
    P = P_full
    w0, w1 = (w.double() for w in S.gaussian_reparam(
        torch.full((P,), 0.5, device="cuda"), torch.zeros(P, device="cuda"),
        (55, 9), 2))
    sd = math.log(2.0)
    se = sd / math.sqrt(P)
    corr = float(torch.corrcoef(torch.stack([w0, w1]))[0, 1])
    stats = {"mean": float(w0.mean()), "std": float(w0.std()),
             "corr_draws": corr}
    del w0, w1
    log(f"reparam moments at P={P} (mu 0.5, sigma ln 2): {json.dumps(stats)}")
    if not (abs(stats["mean"] - 0.5) < 5 * se
            and abs(stats["std"] - sd) < 10 * se
            and abs(corr) < 5 / math.sqrt(P)):
        raise AssertionError(f"reparam moments off: {stats}")

    try:
        S.gaussian_reparam(torch.zeros(1024, device="cuda",
                                       requires_grad=True),
                           torch.zeros(1024, device="cuda"), (1, 2))
    except ValueError as e:
        log(f"reparam_sampler refuses inputs that require grad: {e}")
    else:
        raise AssertionError("gaussian_reparam took inputs requiring grad")

    # times at the path's point: f32 in and out, one draw
    mu = torch.randn(P, device="cuda", generator=g)
    rho = torch.rand(P, device="cuda", generator=g) * 55 - 30
    ms = cuda_ms(lambda: S.gaussian_reparam(mu, rho, (1, 2)), 50)
    plain_ms = cuda_ms(lambda: S.reparam_plain(mu, rho, (1, 2), 1, f32), 3)
    std = S.softplus_k(rho)
    lib_ms = cuda_ms(lambda: torch.normal(mu, std, generator=g), 50)
    b_ms, b_by = bound_ms(3 * P * 4, (P // 2) * REPARAM_F32_OPS)
    log(f"reparam_sampler 1 draw f32 at P={P}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, torch.normal(mu, std) {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {3 * P * 4 / 1e9:.3f} GB); "
        f"{philox_note(P, 1)}")
    return {"name": "reparam_sampler", "route": "cuda",
            "source": "multimodal_auv_torch/csrc/sampling.cu",
            "replaces": "multimodal_auv_tpu/ops/sampling.py:186",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def check_sample_and_apply_card_vs_cpu() -> None:
    """One micro() unimodal ``sample_and_apply`` on the card and on the CPU
    from the same generators: the kernel's softplus (libdevice) and the CPU
    plain version's may differ in the last ulp, and the f32 forwards
    (TF32 off) in summation order; logits to atol 1e-4."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_unimodal_bundle,
    )

    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        b = make_unimodal_bundle(3, NUM_CLASSES, BNNPriorSpec(),
                                 torch.Generator().manual_seed(0),
                                 ArchConfig.micro(), device=dev)
        outs.append(b.sample_and_apply(torch.Generator().manual_seed(5),
                                       x.to(dev)).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"sample_and_apply card vs CPU: {err:.2e}")
    log(f"sample_and_apply card == CPU at micro(): logits max abs err "
        f"{err:.2e} (atol 1e-4)")


def phase_models(args, smi: str):
    """Phase 9: ``define_models`` at full width on the card and one
    ``sample_and_apply`` per Bayesian bundle. Returns (the models, the
    reparam_sampler launches of the counted run)."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        define_models,
    )
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import sampling as S

    t0 = time.perf_counter()
    models = define_models(NUM_CLASSES, BNNPriorSpec(),
                           torch.Generator().manual_seed(args.seed + 20),
                           ArchConfig())
    torch.cuda.synchronize()
    log(f"define_models at full width on the card in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{k} P={v.meta.n_padded}" for k, v in models.items()
            if hasattr(v, "meta")))
    rng = np.random.default_rng(args.seed + 21)
    x = {c: torch.from_numpy(rng.standard_normal(
        (BATCH, IMAGE, IMAGE, c)).astype(np.float32)).cuda() for c in (1, 3)}
    inputs = {"image_model": (x[3],), "bathy_model": (x[3],),
              "sss_model": (x[1],), "multimodal_model": (x[3], x[3], x[1])}
    first_bn = {"image_model": ("model", "bn1"),
                "bathy_model": ("model", "bn1"), "sss_model": ("model", "bn1"),
                "multimodal_model": ("sss_model_feat", "bn1")}
    reset_launches()
    for i, (name, xs) in enumerate(inputs.items()):
        b = models[name]
        logits, new = b.sample_and_apply(
            torch.Generator().manual_seed(args.seed + 30 + i), *xs,
            mutable=True)
        mean = b.apply_mean(*xs)
        torch.cuda.synchronize()
        for what, t in (("sample_and_apply", logits), ("apply_mean", mean)):
            if t.shape != (BATCH, NUM_CLASSES) or not bool(
                    torch.isfinite(t).all()):
                raise AssertionError(f"{name} {what}: {tuple(t.shape)}, "
                                     f"finite {bool(torch.isfinite(t).all())}")
        old, upd = b.batch_stats, new
        for k in first_bn[name]:
            old, upd = old[k], upd[k]
        if torch.equal(old["var"], upd["var"]) or torch.equal(old["mean"],
                                                              upd["mean"]):
            raise AssertionError(f"{name}: the running statistics did not "
                                 f"move")
    for name, c in (("image_model_feat", 3), ("bathy_model_feat", 3),
                    ("sss_model_feat", 1)):
        t = models[name]
        feats = t["module"](t["variables"]["params"],
                            t["variables"]["batch_stats"], x[c], train=False)
        if feats.shape != (BATCH, 2048) or not bool(
                torch.isfinite(feats).all()):
            raise AssertionError(f"{name} features {tuple(feats.shape)}")
    torch.cuda.synchronize()
    launches = check_launches("define_models / sample_and_apply",
                              {"reparam_sampler": 4})
    log(f"sample_and_apply (mutable) and apply_mean on the 4 Bayesian bundles "
        f"at batch {BATCH}, 256 px, bf16: finite (4, 7) logits, running "
        f"statistics moved; trunks' features (4, 2048) finite; launches "
        f"{launches} [{smi}]")
    post = models["image_model"].post
    P = post.mu.numel()
    ms = cuda_ms(lambda: S.gaussian_reparam(post.mu, post.rho, (1, 2)), 50)
    b_ms, _ = bound_ms(3 * P * 4, (P // 2) * REPARAM_F32_OPS)
    log(f"reparam_sampler 1 draw f32 at the unimodal P={P}: kernel {ms:.4f} "
        f"ms, bound {b_ms:.4f} ms (bytes); {philox_note(P, 1)}")
    check_sample_and_apply_card_vs_cpu()
    return models, launches["reparam_sampler"]


def write_inference_tree(root: str, seed: int, n: int) -> str:
    """``n`` sample folders that ``InferenceFolderDataset`` accepts (a
    Frame_*.jpg main image, a *SSS* image, patch_30m_combined_bathy.png) of
    random 256 px images, made from ``seed``."""
    from PIL import Image

    rng = np.random.default_rng(seed + 200)
    img = lambda c: Image.fromarray(np.squeeze(rng.integers(
        1, 256, (IMAGE, IMAGE, c), dtype=np.uint8)))
    for i in range(n):
        d = os.path.join(root, f"dive_{i:03d}")
        os.makedirs(d)
        img(3).save(os.path.join(d, f"Frame_{i:04d}.jpg"))
        img(1).save(os.path.join(d, f"line_SSS_{i}.png"))
        img(3).save(os.path.join(d, "patch_30m_combined_bathy.png"))
    return root


def phase_unimodal_inference(args, smi: str, bundle, work: str) -> None:
    """Phase 10: ``unimodal_predict_and_save`` over an inference tree."""
    from multimodal_auv_torch.data.loaders import prepare_inference_dataloader
    from multimodal_auv_torch.engine.predict import CSV_HEADER
    from multimodal_auv_torch.pipelines.unimodal import (
        unimodal_predict_and_save,
    )

    root = write_inference_tree(os.path.join(work, "dives"), args.seed,
                                N_SAMPLES)
    csv_path = os.path.join(OUT_DIR, "unimodal_predictions.csv")
    run = lambda: unimodal_predict_and_save(
        bundle, prepare_inference_dataloader(root, batch_size=UNI_BATCH),
        csv_path, num_mc_samples=UNI_MC, model_type="image",
        generator=torch.Generator().manual_seed(args.seed + 40))
    run()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batches = -(-N_SAMPLES // UNI_BATCH)
    launches = check_launches("unimodal inference",
                              {"stacked_sampler": n_batches * UNI_MC})
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    names = sorted(r[0] for r in rows[1:])
    if (rows[0] != CSV_HEADER or names != [f"Frame_{i:04d}.jpg"
                                           for i in range(N_SAMPLES)]
            or not np.isfinite(vals).all()
            or not ((vals[:, 0] >= 0) & (vals[:, 0] < UNI_CLASSES)).all()
            or not ((vals[:, 1] >= 0) & (vals[:, 2] >= 0) & (
                vals[:, 2] <= math.log(UNI_CLASSES) + 1e-4)).all()):
        raise AssertionError(f"unimodal CSV: {rows}")
    log(f"unimodal inference: {N_SAMPLES} folders (decode included), "
        f"{n_batches} batches of {UNI_BATCH} x {UNI_MC} MC, optical image, "
        f"full width, in {wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s "
        f"[{smi}]; CSV ok ({len(rows) - 1} rows, classes "
        f"{sorted(set(vals[:, 0]))}); launches {launches}")


def phase_unimodal_training(args, smi: str, work: str) -> None:
    """Phase 11: ``run_unimodal_training`` on the card over a survey tree."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.data.loaders import split_indices
    from multimodal_auv_torch.engine.loops import (
        UNIMODAL_EVAL_CSV_HEADER,
        UNIMODAL_TRAIN_CSV_HEADER,
    )
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_unimodal_bundle,
    )
    from multimodal_auv_torch.pipelines import unimodal as pipeline

    root = write_training_tree(os.path.join(work, "uni_tree"), args.seed)
    # the pipeline's starting posterior, built the same way on the CPU
    before = make_unimodal_bundle(1, NUM_CLASSES, BNNPriorSpec(),
                                  torch.Generator().manual_seed(args.seed),
                                  ArchConfig(), device="cpu")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_train_steps(pipeline) as (times, _):
        state = pipeline.run_unimodal_training(
            root, model_type="sss", num_epochs=2, num_mc=UNI_TRAIN_MC,
            batch_size=UNI_TRAIN_BATCH, seed=args.seed, strict_errors=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_idx, test_idx = split_indices(TRAIN_SAMPLES)
    n_steps = -(-len(train_idx) // UNI_TRAIN_BATCH)
    launches = check_launches("unimodal training", {
        "stacked_sampler": n_steps * UNI_TRAIN_MC * 2,
        "eps": n_steps * UNI_TRAIN_MC,
        "split_sampler": -(-len(test_idx) // UNI_TRAIN_BATCH) * UNI_TRAIN_MC})
    peak = torch.cuda.max_memory_allocated() / 2**30
    if state.step != n_steps or len(times) != n_steps:
        raise AssertionError(f"{state.step} steps, {len(times)} timed; want "
                             f"{n_steps}")
    for k in ("mu", "rho"):
        d = float((getattr(state.post, k).detach().cpu()
                   - getattr(before.post, k)).abs().max())
        if not 0 < d < 1e-3:
            raise AssertionError(f"unimodal {k} moved by {d:.3e}, want "
                                 f"(0, 1e-3)")
    var = lambda bs: bs["model"]["bn1"]["var"].cpu()
    if torch.equal(var(state.batch_stats), var(before.batch_stats)):
        raise AssertionError("unimodal running statistics did not move")
    csv_dir = os.path.join(root, "csvs")
    for name, head in (("unimodal_sss_train_results.csv",
                        UNIMODAL_TRAIN_CSV_HEADER),
                       ("unimodal_sss_eval_results.csv",
                        UNIMODAL_EVAL_CSV_HEADER)):
        with open(os.path.join(csv_dir, name), newline="") as f:
            rows = list(csv.reader(f))
        if (rows[0] != head or len(rows) != 2 or rows[1][:2] != ["2", "sss"]
                or not np.isfinite([float(v) for v in rows[1][2:]]).all()):
            raise AssertionError(f"{name}: {rows}")
        log(f"{name}: {rows[1]}")
    # the confusion matrix is a PNG drawn with matplotlib, which a machine
    # may lack: then it is a logged warning, as in the reference
    png = os.path.join(csv_dir, "confusion_matrices",
                       "conf_matrix_model_sss_1.png")
    if importlib.util.find_spec("matplotlib") is None:
        cm_note = "confusion matrix PNG not drawn (no matplotlib here)"
    elif not os.path.exists(png):
        raise AssertionError(f"no confusion matrix at {png}")
    else:
        cm_note = "confusion matrix PNG ok"
    with open(os.path.join(csv_dir, "run_manifest.json")) as f:
        platform = json.load(f)["devices"]["platform"]
    if platform != "cuda":
        raise AssertionError(f"run manifest platform {platform!r}")
    later = times[1:]
    per_step = sum(later) / len(later)
    log(f"unimodal training: run_unimodal_training sss, epoch 0 skipped, 1 "
        f"epoch over {TRAIN_SAMPLES} folders (scan and decode included), "
        f"{len(train_idx)} train samples in {n_steps} steps of "
        f"{UNI_TRAIN_BATCH} x {UNI_TRAIN_MC} MC (chunk 1, remat on, f32) and "
        f"{len(test_idx)} eval samples, in {wall:.2f} s [{smi}]; steps "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {per_step:.3f} s per step "
        f"after the first = {UNI_TRAIN_BATCH / per_step:.3f} samples/s; peak "
        f"memory {peak:.2f} GiB; ledgers and manifest ok, {cm_note}; "
        f"launches {launches}")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _stem(bundle, prefix: str):
    """(slice, HWIO shape) of ``prefix``'s conv1 kernel in the packed
    vectors."""
    e = next(e for e in bundle.meta.entries
             if e.path == (prefix, "conv1", "kernel"))
    return slice(e.offset, e.offset + e.size), e.shape


def _leaves_equal(a, b) -> bool:
    la, lb = dict(_walk(a)), dict(_walk(b))
    return la.keys() == lb.keys() and all(
        torch.equal(v.cpu(), lb[k].cpu()) for k, v in la.items())


def write_torchvision_trunk(path: str, seed: int) -> dict:
    """A full-width torchvision-named ResNet-50 state dict at ``path``: the
    port's own trunk at its random init from ``seed`` (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ...) plus a 1000-class ``fc``, the
    ImageNet file's layout. Returns it as CPU tensors."""
    from multimodal_auv_torch.interop.hf_manifest import flax_to_torch_mods
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        trunk_module,
    )

    params, stats = trunk_module(ArchConfig()).init(
        torch.Generator().manual_seed(seed), 3)
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    sd = {}
    for tree in (params, stats):
        for p, leaf in _walk(tree):
            key = ".".join(flax_to_torch_mods(p[:-1]) + (names[p[-1]],))
            sd[key] = (leaf.permute(3, 2, 0, 1) if leaf.dim() == 4
                       else leaf).contiguous()
    g = torch.Generator().manual_seed(seed + 1)
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.02
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def check_pretrained_define_models(args, smi: str, work: str) -> None:
    """``define_models(pretrained_paths=...)`` at full width on the card
    with a torchvision-named ResNet-50 file for all three trunks: conv1's
    mu is the file's, sigma = 0.1 |w|, the 1-channel sss conv1 keeps its
    random init (not the file's), the feature trunks hold the file's
    weights; no kernel launches."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        define_models,
    )

    tv_path = os.path.join(work, "resnet50_torchvision.pth")
    sd = write_torchvision_trunk(tv_path, args.seed + 60)
    reset_launches()
    t0 = time.perf_counter()
    models = define_models(NUM_CLASSES, BNNPriorSpec(),
                           torch.Generator().manual_seed(args.seed + 61),
                           ArchConfig(),
                           pretrained_paths={"image": tv_path,
                                             "channels": tv_path,
                                             "sss": tv_path})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("define_models(pretrained_paths)", {})
    conv1 = sd["conv1.weight"].permute(2, 3, 1, 0).cuda()  # HWIO
    worst = 0.0
    for name, pre in (("image_model", "model"), ("bathy_model", "model"),
                      ("multimodal_model", "image_model_feat"),
                      ("multimodal_model", "bathy_model_feat")):
        b = models[name]
        sl, shape = _stem(b, pre)
        mu = b.post.mu[sl].view(shape)
        if not torch.equal(mu, conv1):
            raise AssertionError(f"{name} {pre} conv1 mu != the file's")
        want = torch.clamp_min(0.1 * mu.abs(), 1e-12)
        rel = float(((softplus(b.post.rho[sl].view(shape)) - want).abs()
                     / want).max())
        worst = max(worst, rel)
        if rel > 1e-5:
            raise AssertionError(f"{name} {pre} conv1 sigma off 0.1 |w|: "
                                 f"{rel:.2e} relative")
    first = conv1[:, :, :1, :]  # the file's conv1 over one channel
    for name, pre in (("sss_model", "model"),
                      ("multimodal_model", "sss_model_feat")):
        sl, shape = _stem(models[name], pre)
        if shape != first.shape or torch.equal(
                models[name].post.mu[sl].view(shape), first):
            raise AssertionError(f"{name} {pre} conv1 took the file's "
                                 f"weights")
    for name in ("image_model_feat", "bathy_model_feat"):
        got = models[name]["variables"]["params"]["conv1"]["kernel"]
        if not torch.equal(got.cpu(), sd["conv1.weight"]):
            raise AssertionError(f"{name} conv1 != the file's")
    log(f"define_models(pretrained_paths) at full width on the card in "
        f"{wall:.1f} s: conv1 mu == the file's, sigma == 0.1 |w| (max "
        f"{worst:.1e} relative), sss conv1 kept its random init, feature "
        f"trunks hold the file's weights; no launches [{smi}]")


def phase_pretrained_inference(args, smi: str, work: str):
    """Phase 13: a full-width checkpoint in the published form, imported
    bit for bit, then the inference CLI with ``--model_weights`` on phase
    10's tree. Returns (the checkpoint's path, the CLI run's split_sampler
    launches)."""
    from multimodal_auv_torch import cli
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.predict import (
        multimodal_predict_and_save_packed,
    )
    from multimodal_auv_torch.interop import torch_import as TI
    from multimodal_auv_torch.interop.hf_manifest import load_manifest
    from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )

    src = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                 torch.Generator().manual_seed(args.seed + 50),
                                 ArchConfig(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 51)
    n = src.meta.n_real  # a file holds no pad
    with torch.no_grad():  # perturbed, so that equality means something
        src.post.mu[:n] += 1e-3 * torch.randn(n, device="cuda", generator=g)
        src.post.rho[:n] += 0.1 * torch.randn(n, device="cuda", generator=g)
    path = os.path.join(work, "pytorch_model.bin")
    t0 = time.perf_counter()
    save_torch_checkpoint(src, path, published=True)
    t_write = time.perf_counter() - t0

    # time the two halves of load_and_prepare_multimodal_model
    times = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return out

        return run

    load, imp = TI.load_torch_state_dict, TI.import_posterior
    TI.load_torch_state_dict = timed("load", load)
    TI.import_posterior = timed("import", imp)
    try:
        dst = make_multimodal_bundle(
            NUM_CLASSES, BNNPriorSpec(),
            torch.Generator().manual_seed(args.seed + 52), ArchConfig(),
            device="cuda")
        dst, stats = TI.load_and_prepare_multimodal_model(dst, path,
                                                          NUM_CLASSES)
    finally:
        TI.load_torch_state_dict, TI.import_posterior = load, imp
    if not (torch.equal(dst.post.mu, src.post.mu)
            and torch.equal(dst.post.rho, src.post.rho)
            and _leaves_equal(dst.post.det, src.post.det)
            and _leaves_equal(dst.batch_stats, src.batch_stats)):
        raise AssertionError("the imported posterior differs from the "
                             "exported one")
    inventory = load_manifest()
    n_ignored = sum(v["role"] == "ignored" for v in inventory.values())
    want = {"loaded": len(inventory) - n_ignored, "dropped": 0,
            "ignored": n_ignored, "missing": [], "unexpected": []}
    if stats != want:
        raise AssertionError(f"import stats {stats}, want {want}")
    del dst
    free_cuda()
    log(f"published checkpoint ({len(inventory)} keys, "
        f"{os.path.getsize(path) / 1e9:.3f} GB): write {t_write:.2f} s, "
        f"torch.load {times['load']:.2f} s, import {times['import']:.2f} s "
        f"[{smi}]; mu, rho, det, batch_stats bit-equal; stats {stats}")

    dives = os.path.join(work, "dives")  # phase 10's tree
    csv_cli = os.path.join(OUT_DIR, "pretrained_predictions.csv")
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["inference", "--data_dir", dives, "--output_csv", csv_cli,
                   "--batch_size", str(BATCH), "--num_mc_samples",
                   str(NUM_MC), "--model_weights", path, "--packed_loader",
                   "--mc_chunk", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the inference CLI exited {rc}")
    n_batches = -(-N_SAMPLES // BATCH)
    launches = check_launches("inference CLI",
                              {"split_sampler": n_batches * NUM_MC // 2})
    csv_ref = os.path.join(OUT_DIR, "pretrained_predictions_direct.csv")
    multimodal_predict_and_save_packed(
        src, os.path.join(dives, f".packed_cache_{IMAGE}"), csv_ref,
        num_mc_samples=NUM_MC, batch_size=BATCH,
        generator=torch.Generator().manual_seed(1), mc_chunk=2,
        device="cuda")
    with open(csv_cli, "rb") as f, open(csv_ref, "rb") as f2:
        got, ref = f.read(), f2.read()
    if got != ref:
        raise AssertionError(f"the CLI's CSV differs from the source "
                             f"bundle's:\n{got.decode()}\n{ref.decode()}")
    log(f"inference CLI (--model_weights, --packed_loader): {N_SAMPLES} "
        f"folders (pack included), {n_batches} batches of {BATCH} x {NUM_MC} "
        f"MC, chunk 2, in {wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s "
        f"[{smi}]; CSV byte-equal to the source bundle's; launches "
        f"{launches}")
    del src
    free_cuda()
    check_pretrained_define_models(args, smi, work)
    return path, launches["split_sampler"]


def phase_retraining(args, smi: str, work: str, weights: str) -> dict:
    """Phase 14 (BASELINE.json configs[3]): the retrain CLI from the phase
    13 checkpoint with a 4-class head swap and a frozen backbone, one
    epoch at b12 x 20 MC (chunk 1, remat on, f32 posterior) over a
    32-folder tree of 4 classes. Returns the epoch's launch counts."""
    from multimodal_auv_torch import cli
    from multimodal_auv_torch.bayes.packing import tree_to
    from multimodal_auv_torch.data.loaders import split_indices
    from multimodal_auv_torch.engine.optim import make_backbone_freeze_mask
    from multimodal_auv_torch.interop import torch_import as TI
    from multimodal_auv_torch.pipelines import training as pipeline

    classes = 4
    root = write_training_tree(os.path.join(work, "retrain_tree"), args.seed,
                               classes)
    state_path = os.path.join(work, "retrain_state.pt")
    imported = {}
    load = TI.load_and_prepare_multimodal_model

    def recorded(bundle, *a, **kw):  # the posterior as imported
        bundle, stats = load(bundle, *a, **kw)
        imported.update(
            stats=stats,
            frozen=make_backbone_freeze_mask(bundle.meta,
                                             bundle.post).mu.cpu() == 0,
            mu=bundle.post.mu.detach().to("cpu", copy=True),
            rho=bundle.post.rho.detach().to("cpu", copy=True),
            det=tree_to(bundle.post.det, "cpu"),
            bs={k: v.cpu() for k, v in _walk(bundle.batch_stats)})
        return bundle, stats

    TI.load_and_prepare_multimodal_model = recorded
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with timed_train_steps(pipeline) as (times, _), contextlib.chdir(work):
            rc = cli.main([
                "retrain", "--data_dir", root, "--model_weights", weights,
                "--num_classes", str(classes), "--freeze_backbone",
                "--packed_loader", "--batch_size_multimodal",
                str(TRAIN_BATCH), "--num_mc_samples", str(NUM_MC),
                "--mc_chunk", "1", "--remat", "on",
                "--num_epochs_multimodal", "1", "--resume_checkpoint",
                state_path, "--strict_errors", "--device", "cuda"])
            torch.cuda.synchronize()
    finally:
        TI.load_and_prepare_multimodal_model = load
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the retrain CLI exited {rc}")
    train_idx, test_idx = split_indices(TRAIN_SAMPLES)
    n_steps = -(-len(train_idx) // TRAIN_BATCH)
    launches = check_launches("retraining", {
        "stacked_sampler": n_steps * NUM_MC * 2, "eps": n_steps * NUM_MC,
        "split_sampler": -(-len(test_idx) // TRAIN_BATCH) * NUM_MC})
    peak = torch.cuda.max_memory_allocated() / 2**30
    if imported["stats"]["dropped"] != 4:
        raise AssertionError(f"import stats {imported['stats']}: want fc2's "
                             f"4 mu / rho keys dropped")
    st = torch.load(state_path, map_location="cpu", weights_only=True)["state"]
    check_training_outputs(root, "multimodal_bathy_patch30_sss_patch30", st)
    frozen = imported["frozen"]
    for k in ("mu", "rho"):
        if not torch.equal(st["post"][k][frozen], imported[k][frozen]):
            raise AssertionError(f"frozen {k} changed")
        if torch.equal(st["post"][k][~frozen], imported[k][~frozen]):
            raise AssertionError(f"the head's {k} did not move")
    if not _leaves_equal(st["post"]["det"], imported["det"]):
        raise AssertionError("a frozen BatchNorm affine leaf changed")
    # the optimizer's leaves: mu, rho, then the det leaves (all frozen)
    for i, moments in st["opt_state"]["state"].items():
        m = frozen if i < 2 else slice(None)
        for name in ("exp_avg", "exp_avg_sq"):
            if bool(moments[name][m].any()):
                raise AssertionError(f"Adam {name} of leaf {i} is nonzero on "
                                     f"frozen elements")
    var = ("image_model_feat", "bn1", "var")
    if torch.equal(dict(_walk(st["batch_stats"]))[var], imported["bs"][var]):
        raise AssertionError("the running statistics did not move")
    per_step = sum(times[1:]) / len(times[1:])
    log(f"retraining (BASELINE.json configs[3]): retrain CLI, 7 -> {classes} "
        f"classes, frozen backbone, 1 epoch over {TRAIN_SAMPLES} folders "
        f"(import, scan, decode and pack included), {len(train_idx)} train "
        f"samples in {n_steps} steps of {TRAIN_BATCH} x {NUM_MC} MC (chunk 1, "
        f"remat on, f32 posterior) and {len(test_idx)} eval samples, in "
        f"{wall:.2f} s [{smi}]; steps {', '.join(f'{t:.3f}' for t in times)} "
        f"s; {per_step:.3f} s per step after the first = "
        f"{TRAIN_BATCH / per_step:.3f} samples/s; peak memory {peak:.2f} "
        f"GiB; import stats dropped {imported['stats']['dropped']}, ignored "
        f"{imported['stats']['ignored']}; trunks and BN affine bit-unchanged "
        f"with zero Adam moments, head moved, running statistics moved; "
        f"launches {launches}")
    return launches


def check_probe_kernels(P_full: int) -> None:
    """Every kernel the RNG-split probe launches (its three and the eps
    kernel, its ``bm``) against its plain version, bit for bit: at the
    small and quarter-ending P's (1-3 draws) and the full model's P (2
    draws), f32 and bf16 out (eps_fast: bf16 only), and at the shapes the
    probe runs: its P at its 20 draws in bf16, and at the fidelity check's
    2 draws in f32. Raises on the first difference."""
    from multimodal_auv_torch.ops import probe_rng_split as PR

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(P, n, dt) for P in SMALL_PS for n in (1, 2, 3)
             for dt in (f32, bf16)]
    cases += [(P_full, 2, f32), (P_full, 2, bf16),
              (PR.PROBE_P, PR.PROBE_DRAWS, bf16), (PR.PROBE_P, 2, f32)]
    for P, n, dt in cases:
        for name, (fn, plain) in PR.LAUNCHED.items():
            if name == "eps_fast" and dt != bf16:
                continue
            seed = (1111 * n + P % 1000, 2222)
            got = fn(P, seed, n, "cuda", dt)
            want = plain(P, seed, n, "cuda", dt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                e = float((got.float() - want.float()).abs().max())
                raise AssertionError(f"{name} != plain ({dt}, P={P}, "
                                     f"{n} draws): max abs err {e}")
            del got, want
    log(f"rng_bits, rng_bmlite, eps_fast, eps == plain bit for bit at "
        f"{', '.join(f'P={P} x {n} {str(dt)[6:]}' for P, n, dt in cases)}")


def phase_probe(smi: str, P_full: int) -> list:
    """The RNG-split probe (``multimodal_auv_torch.ops.probe_rng_split``)
    as a phase: its kernels against their plain versions, then its run at
    the TPU probe's geometry with exact launch counts; times of each probe
    kernel at one draw beside its plain version, ``torch.randn`` and its
    bound. Returns their kernels-line entries; their max abs error is 0,
    since any difference from the plain versions raises."""
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import probe_rng_split as PR

    check_probe_kernels(P_full)
    iters = 10
    reset_launches()
    res = PR.run(iters=iters)
    launches = check_launches("RNG-split probe", PR.launches_of_run(iters))
    log(f"RNG-split probe [{smi}]:\n{PR.report(res)}")
    log(f"probe launches {launches}")
    P, bf16 = res["P"], torch.bfloat16
    row = {"rng_bits": "bits", "rng_bmlite": "bmlite", "eps_fast": "bmfast"}
    source = {"rng_bits": 78, "rng_bmlite": 93, "eps_fast": 101}
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for name, (_, plain) in PR.KERNELS.items():
        ms = res["rows"][row[name]]["t_1_ms"]
        plain_ms = cuda_ms(lambda: plain(P, PR.PROBE_SEED, 1, "cuda", bf16),
                           3)
        lib_ms = None if name == "rng_bits" else cuda_ms(
            lambda: torch.randn(1, P, device="cuda", dtype=bf16,
                                generator=gen), 50)
        b_ms, b_by = bound_ms(P * 2, (P // 2) * PROBE_F32_OPS[name])
        log(f"{name} 1 draw bf16 at P={P}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, torch.randn "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by}); {philox_note(P, 1)}")
        entries.append({"name": name, "route": "cuda",
                        "source": "multimodal_auv_torch/csrc/sampling.cu",
                        "replaces": f"scripts/probe_rng_split.py:"
                                    f"{source[name]}",
                        "launches": launches[name], "max_abs_err": 0.0,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})
    return entries


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    # every phase passes its weights as a local file: never try the Hub
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, HERE)
    os.makedirs(OUT_DIR, exist_ok=True)
    from multimodal_auv_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off: f32 checks are full f32
    phase_build()
    # bulky work files (packed sets, the survey tree, GB-sized checkpoints)
    # stay out of OUT_DIR, which is kept after the run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        bundle, split_entry = phase_main_path(args, smi, work)
        kernels_line = [split_entry] + phase_training(args, smi, bundle,
                                                      work)
        P_full = bundle.meta.n_padded
        del bundle
        free_cuda()
        reparam_entry = check_reparam_kernel(P_full)
        free_cuda()
        models, reparam_entry["launches"] = phase_models(args, smi)
        phase_unimodal_inference(args, smi, models["image_model"], work)
        del models
        free_cuda()
        phase_unimodal_training(args, smi, work)
        kernels_line.append(reparam_entry)
        free_cuda()
        weights, split_launches = phase_pretrained_inference(args, smi, work)
        free_cuda()
        retrain = phase_retraining(args, smi, work, weights)
        free_cuda()
        # each kernel's launches on the paths: add phases 13 and 14
        retrain["split_sampler"] += split_launches
        for e in kernels_line:
            e["launches"] += retrain[e["name"]]
        kernels_line += phase_probe(smi, P_full)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
