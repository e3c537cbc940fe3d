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
   port never calls), and the kernel's bound. The split sampler (#1, the
   op ``torch.ops.auv.split_sampler``) reads its seed words from a device
   tensor in every check and in its timed calls.
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
   card against autograd through the plain version (1e-6 relative). The
   stacked sampler's bf16-output kernel (``bf16_stacked_kernel``: the
   approximate noise and its bracket, with an exact path) against its
   plain version bit for bit at the small P's for 1, 2, 3 and 10 draws,
   bf16 and f32 in, on random, sigma = |mu| and bf16-tie posteriors
   (``sampler_times.check_bf16_stacked``), the ties with exact-path calls
   counted by the kernel > 0.
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
    the port of scripts/probe_rng_split.py): the device functions every
    noise kernel draws through (``noise_parts``: the radius and the
    angle's sin and cos of all 2^24 words, each polynomial set) against
    their plain versions, bits compared, and the bf16 stacked kernel's
    approximate radius and angle over the same words against the f32
    ones: every deviation within the bracket constants the library holds
    (``sampler_times.check_bracket``); every kernel the probe launches
    (rng_bits, rng_bmlite, eps_fast, and the eps kernel in f32 and bf16)
    against its plain version, bits compared, at the small and
    quarter-ending P's, the full P, and the probe's own shapes (72,941,568
    elements x 20 draws bf16, and x 2 draws f32 for the fidelity check);
    the draw loop's SASS instructions per Box-Muller pair of each kernel
    of the library, by class (``ops/sass.py``); then its run
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

15. serving: the full-width artifact exported on the card from phase 13's
    published-form file through ``export_auv_serving_artifact`` (b4 x 20
    MC in chunks of 2, bf16, BN in train mode), loaded with
    ``load_predict_artifact``; ``predict_batches`` over phase 4's 10
    packed patches (padded tail, masked) against the in-process
    ``make_packed_predict_step`` at the same seeds: the predicted class
    equal on every row, both uncertainties to 1e-3 absolute (bit-equality
    reported when it holds), exactly 30 split_sampler launches; then
    ``make_server`` on 127.0.0.1:0 in a thread, one seeded and two
    concurrent unseeded requests through ``serve_client``: every one
    answered, the seeded one equal to ``predict`` with its seed,
    split_sampler launches == 10 x the device calls ``Metrics`` counted,
    and a shutdown inside a time limit. Prints export and load seconds, the
    programs' sizes, patches/s and request latencies. Then the mc-sharded
    artifact (``mc_shards=MC_SHARDS``, mc_chunk left at all 20 draws: one
    stack of 10 stacked-sampler draws per shard) exported from the same
    file and loaded with both shards on cuda:0 (the script needs one
    card: this checks semantics, not scaling): ``predict_batches`` over phase
    4's patches with exactly 2 x 3 = 6 stacked_sampler launches and no
    other, each batch's logits bit-equal to the one-process stacked path
    (``mc_logits`` through ``gaussian_shift_scale``, one chunk of 20, bf16
    weights) at the same seeds and its CSV columns equal; kernel #2
    through the op ``auv::stacked_sampler`` (seed words read from device
    memory; its bf16 kernel) == its plain version at the shard's shape (10
    draws x the full P, bf16 in and out), its time beside its bound, the
    plain version and ``torch.normal``, the share of its Philox calls that
    took the exact path (the kernel's own counter), and its time over ~2 s
    of back-to-back calls beside the SM clock and power nvidia-smi read
    meanwhile; export s, load s and patches/s beside the unsharded
    artifact's. Then the data-sharded artifact (``data_shards=
    DATA_SHARDS``, chunk 2) at ResNet-50's widths with one bottleneck per
    stage (PAR_STAGES, as phase 18), exported from a published-form file
    written at that depth and loaded with both shards on cuda:0
    (semantics, not scaling): on the first batch the
    two shards' draws bit-equal chunk by chunk and the logits bit-equal to
    the data=2 mesh step (the unfused packed step on two gloo ranks, this
    script with --rank --job serving, from the same file at the same
    seed), and a planted fault (``auv::shard_sum`` returning each shard's
    local sums) not; the distance from the unsharded step's logits at
    that depth printed beside its reduction-order control (the batch
    halves swapped)
    and the unsharded step with its convolutions run per shard's rows
    (cuDNN's kernels at the shards' batch shape, which set that distance
    in bf16);
    then ``predict_batches`` over phase 4's patches with exactly 2 x 30 =
    60 split_sampler launches and no other, the BN rendezvous per batch
    counted; export s, load s, program size and patches/s beside the other
    two artifacts'. Then a (2 data x 2 mc)-sharded micro() artifact on the
    card against the same export on the CPU: predicted classes equal,
    logits within DS_MICRO_RTOL of the largest.

16. DVP (single-pass deterministic variance propagation, engine/moment.py)
    at full width: the DVP step over phase 4's packed set through
    ``multimodal_predict_and_save_packed`` (b4 x 20 feature samples, a
    warm-up run, a counted run, then DVP_REPEATS timed runs): its CSV,
    exactly 3 split_sampler launches (one per batch) in the counted run,
    patches/s over all the timed runs beside phase 4's MC patches/s, and
    peak memory; kernel #1 at the DVP draw shape (the head's 2,945,675
    elements and the batch's 3 x 4 x 2048 features, padded to 128, x 20
    draws, f32 out) == ``split_plain`` bit for bit, its time beside its
    bound; the micro() DVP logits on the card against the CPU's at the
    same seed words (1e-4 absolute); DVP against 20-draw MC on one batch
    at the MOPED spread (argmax agreement, max |d mean_prob|: printed, not
    gated); the guardrail: sigma = 0.5 |mu| gives mode "mc" and exactly
    the MC path's 30 split_sampler launches over the same set; then
    ``export-serving --dvp`` in-process from phase 13's file, the
    artifact loaded, its ``predict_batches`` over phase 4's patches bit-equal
    to the in-process DVP step at the same seeds with meta mode "dvp" and
    exactly 3 split_sampler launches; export s, load s, program size,
    patches/s over DVP_REPEATS timed passes. (f) ``export-serving --dvp
    --data_shards 2`` from the same file, both shards on cuda:0: on the
    first batch the two shards' draws bit-equal (each draws the whole
    batch's features) and the logits bit-equal to the DVP logits function
    on a data=2 mesh of two gloo ranks (this script with --rank --job
    serving_dvp, from the same file at the same seed words), a planted
    local-sums fault and a planted wrong-rows fault (each shard handed the
    other's rows) not; ``predict_batches`` over phase 4's patches with
    exactly 2 x 3 split_sampler launches and as many rendezvous a batch
    as the program holds ``auv::shard_sum`` and ``auv::shard_gather``
    nodes; export s, load s, program size and patches/s over DVP_REPEATS
    timed passes beside (e)'s, and the distance from (e)'s logits.

17. grouped trunks (models/fused.py) at full width over phase 4's set, b4
    x 20 MC in chunks of 2, from the same seeds: the fused and unfused
    logits of one batch in f32 (an f32 copy of the module, f32 draws) to
    FUSED_F32_TOL of the largest logit; the bf16 main path fused against
    unfused: max |d mean_prob| <= FUSED_BF16_PROB_TOL over the 10
    patches, the argmax equal on every patch whose top-2 margin exceeds
    twice that difference (agreement printed for all); exactly 30
    split_sampler launches over the fused run; fused and unfused
    patches/s in the same run (timed alternately); with --profile the
    device events and busy share of one fused and one unfused b4 batch.
18. parallel: two ranks on the card with ``backend="gloo"`` (one process
    each, this script with --rank; a free port on 127.0.0.1), at full
    width and 256 px with one bottleneck per stage (PAR_STAGES: a
    semantics check, cut in depth for the smoke's time limit): one b12 x
    20 MC train step (chunk 1, remat on, lr 1e-3,
    kl_weight 0, so the loss is the CE alone) on a data=2 mesh against
    the same step in one process (rank 0, same seeds and batch) and
    against a control, the one-process step on the batch with its halves
    swapped (the same function, its sums in another order): with bf16
    activations the loss to PAR_LOSS_RTOL_BF16 and the BN running
    statistics after the step to PAR_STATS_RTOL_BF16, the gradients'
    relative L2 errors reported; with f32 activations the loss to
    PAR_LOSS_RTOL, the statistics to PAR_STATS_RTOL and mu's and rho's
    gradients within PAR_GRAD_CONTROL x the control's error (at most
    PAR_GRAD_CAP). The same gates must reject each fault
    of PAR_FAULTS planted in the BN sums for one step (per-rank
    statistics; a backward without its all_reduce). The f32 step with
    fsdp against data=2: gradients and the gathered Adam moment to
    PAR_GRAD_REPEAT, and its state (posterior, gradients, moments) at
    least P floats smaller; each step's state and peak bytes printed.
    Exactly 40 stacked_sampler and 20 eps launches per rank and step,
    nothing else; both ranks' mu equal. Then an mc=2 mesh: the logits of
    phase 4's first batch, 20 draws in chunks of 2, bf16 weights, each
    rank drawing its row of every chunk (10 stacked_sampler launches per
    rank, the draw offset folded into the seed), bit-equal to the
    one-process stacked path. Kernel #2 with bf16 mu, sigma and output at
    the full P against its plain version first (the mc-sharded path's
    form). Then the f32 train step at world size 1 under NCCL against the
    one-process step (PAR_GRAD_REPEAT). Prints each step's seconds and
    collectives.

19. MC variants and the rest of training, at full width, right after
    phase 18 with phase 4's model: (a) pipelined inference over phase 4's
    set (``make_packed_predict_step(pipelined=True)``, chunk k + 1 sampled
    on a second stream): one batch's logits bit-equal to the split path's
    at the same seed words, the CSV byte-equal to the split step's, exactly
    30 split_sampler launches, pipelined and split patches/s timed in turns
    (pipelined, split, split, pipelined); with --profile the share of the
    split kernels' device time that overlaps a kernel of the current
    stream. (b) antithetic inference (``make_predict_step(antithetic=
    True)``, bf16, chunk 1: each draw and its mirror) over the same set:
    finite outputs, exactly 30 stacked_sampler launches (10 a batch); one
    chunk's rows at full P equal [w; (2 mu - w) formed in f32, cast to
    bf16] of the plain sampler bit for bit; micro() card == CPU (classes
    equal, uncertainty to 1e-4); kernel #2 with bf16 mu, sigma and output
    at one draw (its bf16 kernel) == its plain version, its exact-path
    share, its time against its byte bound and ``torch.normal``. (c) per-draw
    remat: one b12 x 20 MC train step in chunks of VAR_CHUNK (f32
    posterior): exactly 2 stacked_sampler and 2 eps launches, its time and
    peak memory; its gradients against remat off at VAR_GRAD_BATCH x
    VAR_GRAD_MC draws in one chunk (f32 activations, cuDNN deterministic)
    within PAR_GRAD_CONTROL x a control (remat off on the rows swapped),
    at least PAR_GRAD_REPEAT, the loss to PAR_LOSS_RTOL. (d)
    ``remat="auto"`` on the unimodal sss b8 x 5 step and the multimodal
    b12 x 20 step: the bytes the no-remat step keeps, the budget and the
    choice; loss (PAR_LOSS_RTOL) and updated posterior (PAR_GRAD_REPEAT,
    relative L2) against the explicitly chosen remat's step from the same
    state and generator; exact launches (3 trial samplings + the step's).
    (e) async checkpoints: ``save_train_state`` of (c)'s full-width state,
    async then sync, each call's wall; the files equal, and a change made
    after the async call not in its file. (f) non-MOPED init: a full-width
    bundle from ``BNNPriorSpec(moped_enable=False)``: mu's and rho's means
    at their init values within 4 x 0.1 / sqrt(n), standard deviations 0.1
    within 1%; one b4 x 20 predict batch finite, exactly 10 split_sampler
    launches.
20. studies (ROADMAP item 9), after phase 16, at full width on a
    STUDY_SAMPLES-folder tree: (a) ``run_noise_study``, turbidity centres
    STUDY_CENTERS at depth 1.0, one degraded fine-tuning epoch each at
    b4 x 5 MC, then a degraded evaluation with the extended metrics: the
    exact launches (per centre 3 steps x 5 draws x 2 stacked, x 1 eps, 5
    split), the CSV's columns (Turbidity, Depth, F1, ECE, Emax and the
    AUROC, "nan" when every prediction errs, as sklearn 1.9 writes it),
    one row per centre, a per-sample CSV per centre; s per train step and
    per evaluation. (b) one batch degraded on the card against the CPU at
    the same turbidity (f32, UIFM_RTOL of the terms the formula adds).
    (c) one evaluation batch under ``utils.profiling.trace``: the Chrome
    trace holds one ``sampler_kernel`` event per launch counted in the
    block (5). (d) ``run_patch_size_sweep``, bathy (10, 30) m x SSS 30 m,
    1 epoch at b8 x 5 MC: exact launches, the summary's 2 rows, each
    combo's eval CSV; s per combo. (e) ``cli.main(["data-prep", ...])``
    on PREP_FRAMES GAVIA JPEGs with telemetry in the COM segment and an
    LZW bathymetry and a deflate SSS GeoTIFF written by the port: exit 0,
    every sample folder's files, and the inference QA report finding main
    and SSS everywhere (its one problem, "missing-bathy" in every folder,
    is the JAX package's too: both name the combined bathy
    combined_channels.png); s per frame. (f) the C++ host runtime
    (``native/``), which must build here: ``load_image_u8`` on (e)'s frames
    through the native decode and resize byte-equal to its fallback (PIL's
    decode, the native resize), RGB and L, the LZW bathymetry's strips
    decoded natively byte-equal to the Python decoder; ms per image of
    each path (and PIL alone) and each LZW decoder's MB/s.
21. learning, after phase 20: tests/test_learning.py:64's recipe on the
    card at micro() and 32 px (LEARN_*): ``run_AUV_training_from_scratch
    (device=None)`` on a separable synthetic tree (tests/fixtures/
    make_tree.py), 10 epochs at b6 x 2 MC, non-MOPED init; the
    end-of-training state restored through ``restore_train_state``; an
    unseen probe tree of clean and ambiguous samples predicted at 16 MC
    (f32 weights), all with cuDNN's deterministic algorithms (the run is
    then reproducible). Gates: clean held-out accuracy >= 0.9, mean predictive
    uncertainty on the ambiguous samples > 1.2 x the clean ones', a finite
    clean-set ECE < 0.30, AUROC(uncertainty -> error) > 0.5 where the
    probe has hits and errors; exact launches of #2 and #3 in training and
    of #1 in its evaluations and the prediction. Prints s per epoch and
    the accuracy.

The kernels line's launches of #1-#3 add phases 13, 14, 15, 16, 17, 18,
19, 20 and 21 to their paths' counts (phase 19's comparison runs not
counted). Beside each sampler's bound the script prints the
noise contract's Philox calls for that launch and their estimated INT32
time, labelled as an estimate; it is not part of ``bound_ms``.

``--profile`` also writes profiler summaries of one inference batch, of
one train step and of one DVP batch to the output directory (``OUT_DIR``),
and measures phase 19's stream overlap. Launch
counts are reset at the start of each counted run, and each phase expects
exactly its own kernels.
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
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# f32 operations per second outside the tensor cores when every operation
# is its own instruction: the kernels are built with --fmad=false, so no
# multiply and add fuse, and the H100 SXM issues 128 f32 instructions per
# SM per clock (CUDA C++ Programming Guide, arithmetic throughput, compute
# capability 9.0): 132 SMs x 128 x 1.98 GHz boost. The data sheet's 67
# TFLOP/s counts a fused multiply-add as two.
F32_OPS_PER_S = 132 * 128 * 1.98e9
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
# phase 16 times this many passes over phase 4's set (a DVP pass takes
# ~0.4 s on an H100, too short a window for a rate on its own)
DVP_REPEATS = 10
# phase 17: f32 fused against unfused logits (one batch), relative to the
# largest |logit| (cuDNN's grouped and plain convolutions sum in other
# orders through 53 layers of train-mode BN); bf16 mean probabilities
FUSED_F32_TOL, FUSED_BF16_PROB_TOL = 1e-3, 2e-2
# phase 18: data=2 against one process at lr 1e-3, MOPED random weights,
# kl_weight 0 (the loss is the CE alone: the KL term is the same function
# of mu and rho on every layout and would hide the CE's differences). The
# gradient is ill-conditioned in the order of its sums there: on an H100
# the one-process step on its batch halves swapped differs from itself by
# ~2e-2 in relative L2 (f32, TF32 off), ~0.5 with bf16 activations. So
# with f32 activations the data=2 gradients are held within
# PAR_GRAD_CONTROL x that control's error, measured in the same run (and
# under PAR_GRAD_CAP), and with bf16 they are only reported. Both steps
# hold the loss (PAR_LOSS_RTOL, PAR_LOSS_RTOL_BF16) and the BN running
# statistics after the step, all leaves in relative L2 (PAR_STATS_RTOL,
# PAR_STATS_RTOL_BF16). On an H100 data=2 read 9.0e-7 (f32) and 2.2e-3
# (bf16) there, and per-rank BN statistics 1.1e-2 and 1.2e-2. Each step's
# gates must also reject the faults of PAR_FAULTS, planted for one step
# each. A step repeated (fsdp against data=2, NCCL at world 1 against one
# process) agrees to cuDNN's run-to-run floor (~5e-6).
PAR_LR, PAR_MU_ATOL, PAR_KL_WEIGHT = 1e-3, 1e-5, 0.0
PAR_LOSS_RTOL, PAR_LOSS_RTOL_BF16 = 1e-6, 1e-4
PAR_STATS_RTOL, PAR_STATS_RTOL_BF16 = 1e-4, 5e-3
PAR_GRAD_CONTROL, PAR_GRAD_CAP, PAR_GRAD_REPEAT = 2.0, 5e-2, 1e-4
PAR_FAULTS = {"data2_bf16": ("bn_local",),
              "data2": ("bn_local", "bn_no_bwd")}
PAR_TIMEOUT = 600      # seconds for the ranks of phase 18
# phase 18's depth: ResNet-50's widths and 256 px with one bottleneck per
# stage (a semantics check of the parallel layer: the data=2, fsdp, mc=2
# and NCCL steps against one process); at ResNet-50's depth (3, 4, 6, 3)
# it took 208-336 s of the smoke's 1200 s limit
PAR_STAGES = (1, 1, 1, 1)
UNI_MC, UNI_BATCH, UNI_CLASSES = 10, 4, 7      # BASELINE.json configs[0]
UNI_TRAIN_MC, UNI_TRAIN_BATCH = 5, 8           # BASELINE.json configs[1]
# phase 19: the b12 x 20 train step in chunks of 10 (per-draw remat), and
# its gradients against remat off where remat off fits at full width (f32
# activations): VAR_GRAD_BATCH x VAR_GRAD_MC draws in one chunk
VAR_CHUNK = 10
VAR_GRAD_BATCH, VAR_GRAD_MC = 2, 6
# phase 20: the noise study (2 turbidity centres, 1 fine-tuning epoch
# each) and the patch-size sweep (2 combos, 1 epoch, the sweep's default
# batch) over a STUDY_SAMPLES-folder tree; data-prep over PREP_FRAMES
# GAVIA frames. The degradation on the card against the CPU: f32, relative
# to the magnitude of the two terms the formula adds
STUDY_SAMPLES, STUDY_BATCH, STUDY_MC = 12, 4, 5
STUDY_CENTERS, STUDY_DEPTH = (0.05, 2.05), 1.0
SWEEP_BATCH, SWEEP_BATHY, SWEEP_SSS = 8, (10, 30), (30,)
PREP_FRAMES, UIFM_RTOL = 6, 1e-6
# phase 20 (f): passes over the frames and the LZW strips per timed path
NATIVE_REPEATS = 5
# phase 15's mc-sharded artifact: the shards, all on cuda:0
MC_SHARDS = 2
# phase 15's data-sharded artifact: the shards, both on cuda:0, held bit for
# bit against the data=2 mesh step (in bf16 its distance from the
# unsharded artifact is set by cuDNN's kernels at the shards' batch shape,
# ~6e-2 of the largest logit on an H100, against a reduction-order control
# of 0-5e-2: no tolerance from the control bounds it); the composed micro()
# artifact, card against CPU (f32, TF32 off: summation order only)
DATA_SHARDS, DS_MICRO_RTOL = 2, 1e-4
# phase 21: tests/test_learning.py:64's recipe on the card (micro(), 32 px:
# learning to 90% is a property of the recipe, not of the width): a
# separable tree of LEARN_CLASSES x LEARN_PER_CLASS samples, LEARN_EPOCHS
# epochs at LEARN_BATCH x LEARN_MC draws, lr 3e-3, non-MOPED init; then
# an unseen probe tree of LEARN_PROBE_PER_CLASS clean and as many
# ambiguous samples per class at LEARN_PROBE_MC draws
LEARN_CLASSES, LEARN_PER_CLASS, LEARN_EPOCHS = 3, 8, 10
LEARN_BATCH, LEARN_MC, LEARN_LR = 6, 2, 3e-3
LEARN_PROBE_PER_CLASS, LEARN_PROBE_MC = 6, 16


# phases 15 and 17-21's results, printed again before the kernels line
# (the tool that runs this script keeps only the end of its output)
SUMMARY = []


def log(msg: str, summary: bool = False) -> None:
    print(msg, flush=True)
    if summary:
        SUMMARY.append(msg)


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
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def philox_calls(P: int, num_draws: int) -> int:
    """The noise contract's Philox calls for one launch over P elements and
    ``num_draws`` draws: one per call j whose element j lies inside P."""
    from multimodal_auv_torch.ops import sampling as S

    return S.philox_calls(P, num_draws)


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


# each source's nvcc log from phase_build (ptxas registers and spills)
BUILD_LOGS = {}


def phase_build():
    from multimodal_auv_torch.ops import kernels

    names = sorted(f[:-3] for f in os.listdir(kernels.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(kernels.build, names)))
    for name, r in results.items():
        BUILD_LOGS[name] = r.log
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
                got = S.gaussian_shift_scale_split(
                    mu, sg, S.seed_tensor(seed, "cuda"), n, out_dtype=dt,
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
            log(f"split_sampler (seed from device memory) == plain bit for "
                f"bit: {dt}, fast_math={fast}, {label} P={mu.numel()}, "
                f"chunks 1,2,3")

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
    seeds = S.seed_tensor((1, 2), "cuda")  # the seed words on the device
    ms = cuda_ms(lambda: S.gaussian_shift_scale_split(
        mu, sg, seeds, 2, out_dtype=torch.bfloat16, fast_math=True), 50)
    plain_ms = cuda_ms(lambda: S.split_plain(mu, sg, (1, 2), 2,
                                             torch.bfloat16, True), 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu2, sg2 = mu.expand(2, P), sg.expand(2, P)
    library_ms = cuda_ms(lambda: torch.normal(mu2, sg2, generator=gen), 50)
    nbytes = 2 * P * 2 + 2 * P * 2
    ops = (P // 2) * 2 * SAMPLER_F32_OPS[True]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    log(f"split_sampler chunk 2 at P={P} (seed from device memory): kernel "
        f"{ms:.4f} ms, plain "
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
    return bundle, entry, N_SAMPLES / wall


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
    return len(kern), busy_ms / wall_ms


def phase_fused(args, smi: str, bundle, work: str) -> int:
    """Phase 17: the grouped trunks against the unfused module at full
    width (see the module docstring). Returns the split_sampler launches
    of its counted run."""
    from multimodal_auv_torch.engine.predict import (
        make_packed_logits_fn,
        make_packed_predict_step,
        multimodal_predict_and_save_packed,
    )
    from multimodal_auv_torch.models.fused import grouped_layer_count
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        ModelBundle,
        multimodal_module,
    )
    from multimodal_auv_torch.ops.sampling import chunk_seed_words

    t_phase = time.perf_counter()
    packed = os.path.join(work, "packed")  # phase 4's set
    batches = [([torch.from_numpy(a).cuda() for a in b[:3]],
                torch.from_numpy(b[3]).cuda().bool())
               for b in _padded_batches(packed)[0]]
    u8, mask = batches[0]

    # (a) f32: an f32 copy of the module over the same posterior, f32 draws
    f32 = ModelBundle(multimodal_module(NUM_CLASSES, ArchConfig(
        dtype=torch.float32)), bundle.post, bundle.meta, bundle.batch_stats)
    seeds = chunk_seed_words(torch.Generator().manual_seed(args.seed + 17),
                             NUM_MC // 2).cuda()
    with torch.inference_mode():
        logits = [make_packed_logits_fn(
            f32, mc_chunk=2, sample_dtype=torch.float32,
            fused_trunks=fused)(bundle.post, bundle.batch_stats, u8, seeds,
                                mask) for fused in (False, True)]
    scale = float(logits[0].abs().max())
    err = float((logits[1] - logits[0]).abs().max())
    log(f"fused f32 logits: max |d| {err:.3e} of max |logit| {scale:.3e} "
        f"(relative {err / scale:.3e}, gate {FUSED_F32_TOL:g}), 1 batch x "
        f"{NUM_MC} draws", summary=True)
    if not err <= FUSED_F32_TOL * scale:
        raise AssertionError(f"fused f32 logits off the unfused: {err}")
    del logits, f32
    free_cuda()

    # (b) bf16, the main path: fused against unfused over phase 4's set
    steps = {fused: make_packed_predict_step(bundle, NUM_MC,
                                             fused_trunks=fused)
             for fused in (False, True)}

    def run(fused, csv_path):
        multimodal_predict_and_save_packed(
            bundle, packed, csv_path, num_mc_samples=NUM_MC,
            batch_size=BATCH,
            generator=torch.Generator().manual_seed(args.seed + 1),
            step=steps[fused], device="cuda")
        torch.cuda.synchronize()

    probs = {}
    for fused in (False, True):
        gen = torch.Generator().manual_seed(args.seed + 1)
        with torch.inference_mode():
            probs[fused] = torch.cat([steps[fused](
                bundle.post, bundle.batch_stats, b_u8, gen, b_mask)[
                "mean_prob"][b_mask].float() for b_u8, b_mask in batches])
    d = float((probs[True] - probs[False]).abs().max())
    top2 = probs[False].topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * d
    agree = probs[True].argmax(1) == probs[False].argmax(1)
    log(f"fused bf16 over {N_SAMPLES} patches: max |d mean_prob| {d:.3e} "
        f"(gate {FUSED_BF16_PROB_TOL:g}); argmax agreement "
        f"{int(agree.sum())}/{N_SAMPLES}, {int(clear.sum())} patches with "
        f"a top-2 margin above 2 x that, all agreeing: "
        f"{bool(agree[clear].all())}", summary=True)
    if not (d <= FUSED_BF16_PROB_TOL and bool(agree[clear].all())):
        raise AssertionError("fused bf16 outputs off the unfused")

    csv_path = os.path.join(OUT_DIR, "fused_predictions.csv")
    for fused in (False, True):
        run(fused, csv_path)  # warm-up: cuDNN's choice for each geometry
    reset_launches()
    run(True, csv_path)
    launches = check_launches("fused path", {
        "split_sampler": -(-N_SAMPLES // BATCH) * NUM_MC // 2})
    check_csv(csv_path)
    walls = {False: [], True: []}
    for fused in (True, False, False, True):
        t0 = time.perf_counter()
        run(fused, os.path.join(work, "fused_timed.csv"))
        walls[fused].append(time.perf_counter() - t0)
    rate = {f: [N_SAMPLES / w for w in ws] for f, ws in walls.items()}
    n_layers = grouped_layer_count(
        bundle.module.image_model_feat.stage_sizes)
    log(f"fused path: {min(rate[True]):.3f}-{max(rate[True]):.3f} patches/s "
        f"against unfused {min(rate[False]):.3f}-{max(rate[False]):.3f} "
        f"(b{BATCH} x {NUM_MC} MC, timed fused, unfused, unfused, fused) "
        f"[{smi}]; launches {launches}; per draw {n_layers} grouped convs "
        f"(3 x {n_layers} unfused), {n_layers} kernel concatenations and "
        f"2 x {n_layers} BN scale / bias concatenations", summary=True)
    if args.profile:
        b_u8, b_mask = batches[0]
        for fused in (True, False):
            gen = torch.Generator().manual_seed(args.seed)
            n, share = profile_run(
                f"one {'fused' if fused else 'unfused'} batch of {BATCH} x "
                f"{NUM_MC} MC", f"profile_fused{int(fused)}.txt",
                lambda: steps[fused](bundle.post, bundle.batch_stats, b_u8,
                                     gen, b_mask))
            log(f"{'fused' if fused else 'unfused'} b{BATCH} batch: {n} "
                f"device events, busy share {share:.3f}", summary=True)
    log(f"phase 17 (fused): {time.perf_counter() - t_phase:.1f} s",
        summary=True)
    return launches["split_sampler"]


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return t.detach().clone()


def parallel_rank(args) -> int:
    """One rank of phase 18 (this script with --rank): joins the process
    group, runs its steps and prints one ``PHASE18 {json}`` line per
    result."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from multimodal_auv_torch.bayes.packing import PackedPosterior
    from multimodal_auv_torch.config import BNNPriorSpec, DistSpec, MeshSpec
    from multimodal_auv_torch.data.packing import load_packed
    from multimodal_auv_torch.device import resolve_device
    from multimodal_auv_torch.engine.mc import mc_logits
    from multimodal_auv_torch.engine.optim import (
        BayesTrainState,
        make_optimizer,
    )
    from multimodal_auv_torch.engine.steps import make_train_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        ModelBundle,
        make_multimodal_bundle,
        multimodal_module,
    )
    from multimodal_auv_torch.ops import kernels
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal
    from multimodal_auv_torch.parallel import collectives as C
    from multimodal_auv_torch.parallel import mesh as M
    from multimodal_auv_torch.parallel.collectives import COUNTS, reset_counts
    from multimodal_auv_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    def emit(**kw):
        print("PHASE18 " + json.dumps(dict(kw, rank=args.rank,
                                           world=args.world,
                                           backend=args.backend)),
              flush=True)

    coord = f"127.0.0.1:{args.port}"
    if args.world > 1:
        maybe_initialize_distributed(DistSpec(
            coordinator=coord, num_processes=args.world,
            process_id=args.rank, initialization_timeout=300,
            backend=args.backend))
    else:  # a group of one, to run the step under NCCL's process group
        torch.cuda.set_device(0)
        dist.init_process_group(args.backend, init_method=f"tcp://{coord}",
                                world_size=1, rank=0)
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError(f"NCCL all_reduce of 1 over 1 rank: {one}")
    try:
        dev = resolve_device(None)
        arch = ArchConfig(stage_sizes=PAR_STAGES)
        base = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                      torch.Generator().manual_seed(args.seed),
                                      arch, device=dev)
        modules = {torch.bfloat16: base.module,
                   torch.float32: multimodal_module(NUM_CLASSES, ArchConfig(
                       stage_sizes=PAR_STAGES, dtype=torch.float32))}
        rng = np.random.default_rng(args.seed + 18)
        inputs = [torch.from_numpy(rng.integers(
            0, 256, (TRAIN_BATCH, IMAGE, IMAGE, c), dtype=np.uint8)).to(dev)
            for c in (3, 3, 1)]
        labels = torch.from_numpy(rng.integers(0, NUM_CLASSES,
                                               TRAIN_BATCH)).to(dev)
        mask = torch.ones(TRAIN_BATCH, device=dev)

        def clone(dtype):
            p = base.post
            return ModelBundle(modules[dtype], PackedPosterior(
                p.mu.detach().clone(), p.rho.detach().clone(),
                _clone_tree(p.det)), base.meta, _clone_tree(base.batch_stats))

        def train(mesh, fsdp=False, dtype=torch.float32, perm=None):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            b = clone(dtype)
            x, y = inputs, labels
            if perm is not None:  # the same batch, its rows reordered
                x, y = [a[perm] for a in x], y[perm]
            tx = make_optimizer(PAR_LR, 1e-5)
            state = BayesTrainState(b.post, tx.init(b.post) if mesh is None
                                    else M.shard_optimizer(mesh, tx, b.post,
                                                           fsdp),
                                    b.batch_stats)
            step = make_train_step(b.module, b.meta, BNNPriorSpec(), NUM_MC,
                                   mc_chunk=1, packed_inputs=True,
                                   remat="on", mesh=mesh)
            if mesh is not None:
                step = M.wrap_train_step(mesh, step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            reset_counts()
            t0 = time.perf_counter()
            state, m = step(state, x, y, mask,
                            torch.Generator().manual_seed(args.seed + 18),
                            PAR_KL_WEIGHT, float(TRAIN_BATCH))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the state's bytes after its first step (posterior, gradients,
            # Adam moments) and the step's peak, both above the start
            mem = {"state_mib": (torch.cuda.memory_allocated() - mem0) / 2**20,
                   "peak_mib": (torch.cuda.max_memory_allocated() - mem0)
                   / 2**20}
            return state, m, dict(kernels.LAUNCHES), dict(COUNTS), wall, mem

        def summary(state, m, launches, coll, wall, mem, label):
            mu = state.post.mu.detach().double()
            emit(label=label, loss=float(m["loss"]), skipped=m["skipped"],
                 mu_sum=float(mu.sum()), mu_sq=float((mu * mu).sum()),
                 launches=launches, collectives=coll, seconds=wall,
                 P=mu.numel(), **mem)

        @contextlib.contextmanager
        def planted(fault):
            """A fault planted in BatchNorm's sums for one step, a negative
            control the gates must reject: "bn_local" skips their
            all_reduce (each rank normalises by its own rows); "bn_no_bwd"
            keeps the forward's sum and drops the all_reduce of its
            backward (the right loss, wrong gradients)."""
            saved = C.all_reduce_sum
            if fault == "bn_local":
                C.all_reduce_sum = lambda t, axis: t
            else:
                C.all_reduce_sum = lambda t, axis: t + (
                    C.all_reduce_(t.detach().clone(), axis) - t.detach())
            try:
                yield
            finally:
                C.all_reduce_sum = saved

        if args.world == 1:
            mesh = M.make_mesh(MeshSpec(1, 1))
            got = train(mesh)
            summary(*got, label="nccl_world1")
            ref = train(None)
            summary(*ref, label="one_process")
            _compare_steps(got[0], ref[0], got[1], ref[1], emit,
                           "nccl_world1")
            return 0

        data2 = M.make_mesh(MeshSpec(2, 1))
        # the control: one process on the same batch with its two halves
        # swapped, the same function with its sums in another order
        halves = torch.arange(TRAIN_BATCH, device=dev).roll(TRAIN_BATCH // 2)
        for dtype, name in ((torch.bfloat16, "data2_bf16"),
                            (torch.float32, "data2")):
            ref = None
            if args.rank == 0:  # rank 1 waits in the first collective
                ref = train(None, dtype=dtype)
                summary(*ref, label=f"one_process_{name}")
                ctl = train(None, dtype=dtype, perm=halves)
                _compare_steps(ctl[0], ref[0], ctl[1], ref[1], emit,
                               f"{name}_control")
                del ctl
            got = train(data2, dtype=dtype)
            summary(*got, label=name)
            if ref is not None:
                _compare_steps(got[0], ref[0], got[1], ref[1], emit, name)
            for fault in PAR_FAULTS[name]:
                with planted(fault):
                    bad = train(data2, dtype=dtype)
                summary(*bad, label=f"{name}_{fault}")
                if ref is not None:
                    _compare_steps(bad[0], ref[0], bad[1], ref[1], emit,
                                   f"{name}_{fault}")
                del bad
            del ref
            if dtype == torch.float32:
                fs = train(data2, fsdp=True)
                summary(*fs, label="data2_fsdp")
                exp = [s.opt_state.state_dict()["state"][0]["exp_avg"]
                       for s in (got[0], fs[0])]
                _compare_steps(fs[0], got[0], fs[1], got[1], emit,
                               "fsdp", exp_avg_rel_l2=_rel(exp[1], exp[0]))
                del fs, exp
            del got
            torch.cuda.empty_cache()

        # mc=2: each rank draws its row of every chunk of 2
        mc2 = M.make_mesh(MeshSpec(1, 2))
        packed = load_packed(os.path.join(args.work, "packed"))
        u8 = [torch.from_numpy(np.asarray(packed[k][:BATCH])).to(dev)
              for k in ("main", "bathy", "sss")]
        bmask = torch.ones(BATCH, dtype=torch.bool, device=dev)

        def logits(ws):
            with torch.inference_mode():
                return mc_logits(
                    base.module, base.meta, base.post, base.batch_stats,
                    normalize_multimodal(*u8),
                    torch.Generator().manual_seed(args.seed + 1), NUM_MC,
                    mc_chunk=2, train=True, remat=False,
                    sample_dtype=torch.bfloat16, batch_mask=bmask,
                    split_sampling=False, ws_sharding=ws)

        torch.cuda.synchronize()
        reset_launches()
        reset_counts()
        t0 = time.perf_counter()
        sharded = logits(mc2)
        torch.cuda.synchronize()
        emit(label="mc2", launches=dict(kernels.LAUNCHES),
             collectives=dict(COUNTS), seconds=time.perf_counter() - t0)
        if args.rank == 0:
            want = logits(None)
            emit(label="mc2_vs_stacked",
                 max_abs=float((sharded.float() - want.float()).abs().max()),
                 bit_equal=bool(torch.equal(sharded, want)),
                 shape=list(sharded.shape))
        return 0
    finally:
        dist.destroy_process_group()


def serving_rank(args) -> int:
    """One rank of phase 15's data=2 mesh step (this script with --rank
    --job serving): the unfused packed step (chunk 2, bf16) on a data=2
    mesh of two gloo ranks, at one bottleneck per stage (PAR_STAGES) from
    the file phase 15 writes at that depth (``--weights``), on phase 4's
    first batch at the data-sharded artifact's seed; prints this rank's
    rows of the logits as one ``PHASE15 {json}`` line. With --job
    serving_dvp, phase 16 (f)'s: the DVP logits function (b4 x 20 feature
    draws, f32) on the same mesh and batch at the data-sharded DVP
    artifact's seed words, as one ``PHASE16 {json}`` line."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import multimodal_auv_torch.engine.predict as P
    from multimodal_auv_torch.config import BNNPriorSpec, DistSpec, MeshSpec
    from multimodal_auv_torch.device import resolve_device
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.parallel import mesh as M
    from multimodal_auv_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from multimodal_auv_torch.pipelines.inference import pretrained_bundle
    from multimodal_auv_torch.serving import fold_seed

    maybe_initialize_distributed(DistSpec(
        coordinator=f"127.0.0.1:{args.port}", num_processes=2,
        process_id=args.rank, initialization_timeout=300, backend="gloo"))
    try:
        dev = resolve_device(None)
        # phase 15's data-sharded MC artifact runs at one bottleneck per
        # stage (its file is written at that depth), phase 16 (f) at full
        # depth
        arch = (ArchConfig() if args.job == "serving_dvp"
                else ArchConfig(stage_sizes=PAR_STAGES))
        bundle = pretrained_bundle(NUM_CLASSES, BNNPriorSpec(), arch,
                                   args.seed, args.weights, False, dev)
        m, b, ss, mask = _padded_batches(os.path.join(args.work,
                                                      "packed"))[0][0]
        if args.job == "serving_dvp":
            return _dvp_rank(args, bundle, (m, b, ss), dev)
        seen, fused = [], P.fused_outputs
        P.fused_outputs = lambda logits: (seen.append(logits),
                                          fused(logits))[1]
        step = P.make_packed_predict_step(bundle, NUM_MC, mc_chunk=2,
                                          mesh=M.make_mesh(MeshSpec(2, 1)))
        step(bundle.post, bundle.batch_stats,
             [torch.from_numpy(a).to(dev) for a in (m, b, ss)],
             torch.Generator().manual_seed(fold_seed(args.seed + 15, 0)),
             torch.from_numpy(mask > 0).to(dev))
        P.fused_outputs = fused
        print("PHASE15 " + json.dumps({
            "rank": args.rank, "logits": seen[0].float().cpu().tolist()}),
            flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def _dvp_rank(args, bundle, batch, dev) -> int:
    """``serving_rank``'s DVP job: this rank's rows of the DVP logits on a
    data=2 mesh (the moment BN's sums and the feature gathers over gloo),
    drawn from the seed words of phase 16 (f)'s first batch."""
    from multimodal_auv_torch.config import MeshSpec
    from multimodal_auv_torch.engine.moment import make_dvp_logits_fn
    from multimodal_auv_torch.ops.sampling import chunk_seed_words
    from multimodal_auv_torch.parallel import mesh as M
    from multimodal_auv_torch.parallel.collectives import bn_sync
    from multimodal_auv_torch.serving import fold_seed

    mesh = M.make_mesh(MeshSpec(2, 1))
    logits_fn = make_dvp_logits_fn(bundle, NUM_MC, packed_inputs=True,
                                   mesh=mesh)
    rows = slice(args.rank * BATCH // 2, (args.rank + 1) * BATCH // 2)
    seeds = chunk_seed_words(torch.Generator().manual_seed(
        fold_seed(args.seed + 16, 0)), 1).to(dev)
    with torch.inference_mode(), bn_sync(mesh.data_axis):
        logits = logits_fn(bundle.post, bundle.batch_stats,
                           [torch.from_numpy(a[rows]).to(dev) for a in batch],
                           seeds)
    print("PHASE16 " + json.dumps({
        "rank": args.rank, "logits": logits.float().cpu().tolist()}),
        flush=True)
    return 0


def _rel(a, b) -> float:
    """Relative L2 error of ``a`` against ``b``."""
    return float((a - b).double().norm() / b.double().norm())


def _flat_stats(tree) -> torch.Tensor:
    """Every running statistic of a BatchNorm tree as one f64 vector."""
    if isinstance(tree, dict):
        return torch.cat([_flat_stats(tree[k]) for k in sorted(tree)])
    return tree.detach().double().reshape(-1)


def _compare_steps(state, ref, m, ref_m, emit, label, **extra) -> None:
    """One train step's result against a reference step's: the loss, the
    gradients' and the updated running statistics' relative L2 errors,
    the share of updated mu within PAR_MU_ATOL and the largest
    differences."""
    d = (state.post.mu.detach() - ref.post.mu.detach()).abs()
    emit(label=f"{label}_vs_ref",
         loss_rel=abs(float(m["loss"]) - float(ref_m["loss"]))
         / abs(float(ref_m["loss"])),
         stats_rel_l2=_rel(_flat_stats(state.batch_stats),
                           _flat_stats(ref.batch_stats)),
         grad_rel_l2={k: _rel(getattr(state.post, k).grad,
                              getattr(ref.post, k).grad)
                      for k in ("mu", "rho")},
         mu_share=float((d <= PAR_MU_ATOL).double().mean()),
         mu_max_abs=float(d.max()),
         rho_max_abs=float((state.post.rho.detach()
                            - ref.post.rho.detach()).abs().max()), **extra)


def _run_ranks(world: int, backend: str, args, work: str,
               job: str = "parallel", weights: str = "") -> list:
    """Run ``world`` ranks of this script (--rank) on ``job`` (phase 18's
    "parallel", phase 15's "serving" or phase 16's "serving_dvp") and
    return their PHASE18 / PHASE15 / PHASE16 results; any rank failing or
    outliving PAR_TIMEOUT fails the phase, and every rank is stopped on
    the way out."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tag = {"parallel": "PHASE18 ", "serving": "PHASE15 ",
           "serving_dvp": "PHASE16 "}[job]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--backend", backend, "--port", str(port),
         "--work", work, "--seed", str(args.seed), "--job", job,
         "--weights", weights],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r}/{world} ({backend}) "
                                 f"exited {p.returncode}:\n{out[-6000:]}")
    return [json.loads(ln[len(tag):]) for out in outs
            for ln in out.splitlines() if ln.startswith(tag)]


def phase_parallel(args, smi: str, bundle, work: str) -> dict:
    """Phase 18 (see the module docstring). Returns the launches of #2 and
    #3 its ranks counted on their paths."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.ops import sampling as S

    t_phase = time.perf_counter()
    # kernel #2 in the mc-sharded path's form: bf16 mu, sigma and output
    with torch.no_grad():
        mu = bundle.post.mu.detach().to(torch.bfloat16)
        sg = softplus(bundle.post.rho.detach().float()).to(torch.bfloat16)
        for n in (1, 2):
            seed = S.draw_offset_seed((2024, 18), n, mu.numel())
            got = S.gaussian_shift_scale(mu, sg, seed, n,
                                         out_dtype=torch.bfloat16)
            want = S.stacked_plain(mu, sg, seed, n, torch.bfloat16)
            if not torch.equal(got, want):
                raise AssertionError(f"stacked_sampler bf16 in and out != "
                                     f"plain at P={mu.numel()}, {n} draws")
            del got, want
    log(f"stacked_sampler == plain bit for bit: bf16 mu, sigma and output, "
        f"P={mu.numel()}, 1 and 2 draws (folded seeds)")
    del mu, sg
    free_cuda()

    res = _run_ranks(2, "gloo", args, work)
    res += _run_ranks(1, "nccl", args, work)
    by = {(r["label"], r["rank"], r["backend"]): r for r in res}
    for r in res:
        body = {k: v for k, v in r.items()
                if k not in ("rank", "world", "backend")}
        log(f"phase 18 {r['backend']} rank {r['rank']}/{r['world']}: "
            f"{json.dumps(body)}", summary=True)
    want = {"stacked_sampler": 2 * NUM_MC, "eps": NUM_MC}
    full = lambda w: {k: w.get(k, 0) for k in by[("data2", 0, "gloo")][
        "launches"]}
    for label in ("data2_bf16", "data2", "data2_fsdp"):
        a, b = by[(label, 0, "gloo")], by[(label, 1, "gloo")]
        for r in (a, b):
            if r["launches"] != full(want) or r["skipped"]:
                raise AssertionError(f"{label}: {r}")
        if (a["mu_sum"], a["mu_sq"]) != (b["mu_sum"], b["mu_sq"]):
            raise AssertionError(f"{label}: the ranks' mu differ")
    grad = lambda key: max(by[key]["grad_rel_l2"].values())
    # f32: data=2 within PAR_GRAD_CONTROL x the control's own error (the
    # one-process step on its batch halves swapped), and under the cap
    # (loss, gradients, running statistics); bf16: no gradient gate
    gates = {"data2_bf16": (PAR_LOSS_RTOL_BF16, None, PAR_STATS_RTOL_BF16),
             "data2": (PAR_LOSS_RTOL, min(
                 PAR_GRAD_CONTROL * grad(("data2_control_vs_ref", 0, "gloo")),
                 PAR_GRAD_CAP), PAR_STATS_RTOL)}
    repeat = (PAR_LOSS_RTOL, PAR_GRAD_REPEAT, PAR_GRAD_REPEAT)

    def held(key, loss_tol, grad_tol, stats_tol) -> bool:
        c = by[key]
        return (c["loss_rel"] <= loss_tol
                and (grad_tol is None or grad(key) <= grad_tol)
                and c["stats_rel_l2"] <= stats_tol
                and c.get("exp_avg_rel_l2", 0.0) <= PAR_GRAD_REPEAT)

    checks = [(("nccl_world1_vs_ref", 0, "nccl"), repeat)]
    checks += [(("fsdp_vs_ref", r, "gloo"), repeat) for r in (0, 1)]
    for name, tols in gates.items():
        checks.append(((f"{name}_vs_ref", 0, "gloo"), tols))
        for fault in PAR_FAULTS[name]:
            key = (f"{name}_{fault}_vs_ref", 0, "gloo")
            if held(key, *tols):
                raise AssertionError(
                    f"{name}'s gates (loss, gradients, statistics {tols}) "
                    f"let the planted fault {fault} through: {by[key]}")
    for key, tols in checks:
        if not held(key, *tols):
            raise AssertionError(f"{key[0]} (gates: loss, gradients, "
                                 f"statistics {tols}): {by[key]}")
    # fsdp keeps (1 - 1/2) of the four P-float moment vectors: its state
    # must be at least one P-float vector smaller than data=2's
    P_mib = by[("data2", 0, "gloo")]["P"] * 4 / 2**20
    for r in range(2):
        fs, d2 = by[("data2_fsdp", r, "gloo")], by[("data2", r, "gloo")]
        if not fs["state_mib"] <= d2["state_mib"] - P_mib:
            raise AssertionError(f"fsdp rank {r}: state {fs['state_mib']:.1f}"
                                 f" MiB, data=2 {d2['state_mib']:.1f} MiB")
    if by[("nccl_world1", 0, "nccl")]["launches"] != full(want):
        raise AssertionError("nccl world 1: launches")
    for r in range(2):
        if by[("mc2", r, "gloo")]["launches"] != full(
                {"stacked_sampler": NUM_MC // 2}):
            raise AssertionError(f"mc=2 rank {r}: launches")
    c = by[("mc2_vs_stacked", 0, "gloo")]
    if not c["bit_equal"]:
        raise AssertionError(f"mc=2 logits != the stacked path's: {c}")
    log(f"phase 18 (parallel, stages {PAR_STAGES}, P="
        f"{by[('data2', 0, 'gloo')]['P']}): data=2, fsdp, mc=2 and NCCL "
        f"world 1 ok [{smi}] in {time.perf_counter() - t_phase:.1f} s",
        summary=True)
    out = {"stacked_sampler": 0, "eps": 0}
    for (label, _, _), r in by.items():
        for k in out:
            out[k] += r.get("launches", {}).get(k, 0) if label in (
                "data2_bf16", "data2", "data2_fsdp", "mc2",
                "nccl_world1") else 0
    return out


def check_train_kernels(post, n_padded: int):
    """Kernels #2 (stacked sampler) and #3 (eps) against their plain
    versions and each other's noise; eps moments; the backward; times.
    Returns their kernels-line entries (launches filled in later)."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.ops.sampler_times import check_bf16_stacked

    g = torch.Generator().manual_seed(1)
    g_cuda = torch.Generator(device="cuda").manual_seed(1)
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
    # the bf16 stacked kernel: 1-3 and 10 draws, bf16 and f32 in, random,
    # sigma = |mu| and bf16-tie posteriors (exact-path calls counted > 0)
    for P in SMALL_PS:
        check_bf16_stacked(P, g_cuda)
    log(f"stacked_sampler bf16 out (bf16_stacked_kernel) == plain bit for "
        f"bit at P={', '.join(map(str, SMALL_PS))}, 1, 2, 3 and 10 draws, "
        f"bf16 and f32 in; random, sigma = |mu| and tie posteriors, the ties "
        f"taking the exact path")

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


def _padded_batches(packed_dir: str):
    """Phase 4's packed set as the artifact's stream: (main, bathy, sss,
    mask) of BATCH rows, the ragged tail padded with its last row and
    masked, as ``_serve_batches`` pads it; and the valid row counts."""
    from multimodal_auv_torch.data.packing import PackedBatches, load_packed

    out, valid = [], []
    for main, bathy, sss, _ in PackedBatches(load_packed(packed_dir), BATCH):
        arrays = [np.asarray(a) for a in (main, bathy, sss)]
        n = arrays[0].shape[0]
        mask = np.zeros((BATCH,), np.float32)
        mask[:n] = 1.0
        arrays = [np.concatenate([a, np.repeat(a[-1:], BATCH - n, 0)])
                  for a in arrays]
        out.append((*arrays, mask))
        valid.append(n)
    return out, valid


def phase_serving(args, smi: str, work: str, weights: str) -> dict:
    """Phase 15: the full-width serving artifact exported on the card from
    phase 13's file, loaded, streamed over phase 4's patches against the
    in-process step, then served over HTTP; then the mc-sharded artifact
    (``phase_serving_mc_shards``). Returns the phase's launches of the
    split and stacked samplers."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.predict import make_packed_predict_step
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact
    from multimodal_auv_torch.pipelines.inference import pretrained_bundle
    from multimodal_auv_torch.serve_client import ServeClient
    from multimodal_auv_torch.serve_http import make_server
    from multimodal_auv_torch.serving import fold_seed, load_predict_artifact

    art_dir = os.path.join(work, "artifact")
    reset_launches()
    t0 = time.perf_counter()
    export_auv_serving_artifact(art_dir, batch_size=BATCH,
                                num_mc_samples=NUM_MC,
                                num_classes=NUM_CLASSES,
                                model_weights_path=weights, mc_chunk=2,
                                seed=args.seed)
    t_export = time.perf_counter() - t0
    check_launches("serving export", {})
    sizes = {f: os.path.getsize(os.path.join(art_dir, f)) / 1e6
             for f in ("program.pt2", "reduce.pt2", "state.npz")}
    free_cuda()
    t0 = time.perf_counter()
    art = load_predict_artifact(art_dir)
    t_load = time.perf_counter() - t0
    if (art.meta["platforms"] != ["cuda"] or art.nchunks != NUM_MC // 2
            or art.meta["num_classes"] != NUM_CLASSES):
        raise AssertionError(f"artifact meta {art.meta}")
    log(f"serving artifact (full width, b{BATCH} x {NUM_MC} MC, chunk 2, "
        f"bf16): export {t_export:.2f} s (bundle and import of the "
        f"published file included), load {t_load:.2f} s; program.pt2 "
        f"{sizes['program.pt2']:.1f} MB, reduce.pt2 "
        f"{sizes['reduce.pt2']:.2f} MB, state.npz {sizes['state.npz']:.1f} "
        f"MB [{smi}]")

    batches, valid = _padded_batches(os.path.join(work, "packed"))
    key = args.seed + 15
    list(art.predict_batches(batches, key=key))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = list(art.predict_batches(batches, key=key))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches("serving artifact",
                              {"split_sampler": len(batches) * NUM_MC // 2})
    n_launches = launches["split_sampler"]

    bundle = pretrained_bundle(NUM_CLASSES, BNNPriorSpec(), ArchConfig(),
                               args.seed, weights, False,
                               torch.device("cuda"))
    step = make_packed_predict_step(bundle, NUM_MC, mc_chunk=2)
    errs, bit_equal = [], True
    for i, ((m, b, ss, mask), n, out) in enumerate(zip(batches, valid, outs)):
        ref = step(bundle.post, bundle.batch_stats,
                   tuple(torch.from_numpy(a).cuda() for a in (m, b, ss)),
                   torch.Generator().manual_seed(fold_seed(key, i)),
                   torch.from_numpy(mask).cuda())
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
        if not np.array_equal(out["predicted"][:n], ref["predicted"][:n]):
            raise AssertionError(f"artifact batch {i}: predicted "
                                 f"{out['predicted']} != in-process "
                                 f"{ref['predicted']}")
        errs.append(float(np.abs(out["csv_cols"][1:, :n]
                                 - ref["csv_cols"][1:, :n]).max()))
        bit_equal &= (np.array_equal(out["csv_cols"], ref["csv_cols"])
                      and np.array_equal(out["mean_prob"], ref["mean_prob"]))
    if max(errs) > 1e-3:
        raise AssertionError(f"artifact vs in-process uncertainties: max abs "
                             f"err {max(errs)}")
    del bundle, step
    free_cuda()
    rate = N_SAMPLES / wall
    log(f"artifact predict_batches: {N_SAMPLES} patches in {len(batches)} "
        f"batches of {BATCH} x {NUM_MC} MC in {wall:.3f} s = "
        f"{rate:.3f} patches/s [{smi}]; against the in-process "
        f"step at the same seeds: predicted equal on every row, "
        f"uncertainties max abs err {max(errs):.3e}, bit-equal "
        f"{bit_equal}; launches {launches}")

    server = make_server(art, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    client = ServeClient(url, timeout=300)
    rng = np.random.default_rng(args.seed + 16)
    req = lambda n: [rng.integers(0, 256, (n, IMAGE, IMAGE, c),
                                  dtype=np.uint8) for c in (3, 3, 1)]
    latency, answers = {}, {}

    def timed(name, arrays, seed=None):
        t0 = time.perf_counter()
        answers[name] = client.predict(*arrays, seed=seed)
        latency[name] = time.perf_counter() - t0

    reset_launches()
    try:
        if client.healthz()["platforms"] != ["cuda"]:
            raise AssertionError("healthz")
        seeded = req(BATCH)
        timed("seeded b4", seeded, seed=7)
        threads = [threading.Thread(target=timed, args=(f"unseeded b{n}",
                                                        req(n)))
                   for n in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        calls = server.service.metrics.device_calls_total
        launches = check_launches("HTTP serving",
                                  {"split_sampler": calls * NUM_MC // 2})
        n_launches += launches["split_sampler"]
    finally:
        t0 = time.perf_counter()
        stopper = threading.Thread(target=server.shutdown, daemon=True)
        stopper.start()
        stopper.join(timeout=60)
        server.server_close()
        thread.join(timeout=60)
        t_stop = time.perf_counter() - t0
    if thread.is_alive() or stopper.is_alive():
        raise AssertionError("the HTTP server did not shut down in 60 s")
    want = {"seeded b4": BATCH, "unseeded b2": 2, "unseeded b3": 3}
    got = {k: int(v["n"]) for k, v in answers.items()}
    if got != want or calls != 3:
        raise AssertionError(f"HTTP answers {got}, device calls {calls}")
    direct = art.predict(*seeded, key=7)
    if not (np.array_equal(answers["seeded b4"]["predicted"],
                           direct["predicted"])
            # the host rounds mean_prob to 6 decimals
            and np.abs(answers["seeded b4"]["mean_prob"]
                       - direct["mean_prob"]).max() <= 1e-6):
        raise AssertionError("the seeded request differs from predict with "
                             "its seed")
    for k, v in answers.items():
        if not (np.isfinite(v["predictive_uncertainty"]).all()
                and np.isfinite(v["aleatoric_uncertainty"]).all()):
            raise AssertionError(f"{k}: non-finite uncertainties")
    log(f"HTTP serving [{smi}]: {calls} device calls for 3 requests, "
        f"latency {', '.join(f'{k} {v:.3f} s' for k, v in latency.items())}"
        f" (two unseeded ones concurrent); seeded answer == predict(key=7); "
        f"shut down in {t_stop:.2f} s; launches {launches} = 10 x device "
        f"calls")
    del art
    free_cuda()
    unsharded = (t_export, t_load, rate, sizes["program.pt2"])
    stacked, mc_sharded, bf16_entry = phase_serving_mc_shards(
        args, smi, work, weights, batches, key, unsharded)
    free_cuda()
    n_launches += phase_serving_data_shards(args, smi, work, batches, key,
                                            (unsharded, mc_sharded))
    return {"split_sampler": n_launches, "stacked_sampler": stacked,
            "bf16_entry": bf16_entry}


def _half_batch_conv_logits(bundle, batch, seed: int) -> torch.Tensor:
    """The unsharded packed step's logits (chunk 2) on ``batch`` with every
    convolution run per data shard's rows and concatenated: the data
    shards' cuDNN kernels (chosen by batch shape) without their split of
    the BN sums."""
    import torch.nn.functional as F

    from multimodal_auv_torch.engine.predict import make_packed_logits_fn
    from multimodal_auv_torch.ops.sampling import chunk_seed_words

    fn = make_packed_logits_fn(bundle, mc_chunk=2)
    conv2d = F.conv2d
    F.conv2d = lambda x, w, *a, **k: torch.cat(
        [conv2d(h, w, *a, **k) for h in x.chunk(DATA_SHARDS)])
    try:
        with torch.inference_mode():
            return fn(bundle.post, bundle.batch_stats,
                      tuple(torch.from_numpy(a).cuda() for a in batch[:3]),
                      chunk_seed_words(torch.Generator().manual_seed(seed),
                                       NUM_MC // 2).cuda(),
                      torch.from_numpy(batch[3]).cuda()).float().cpu()
    finally:
        F.conv2d = conv2d


def phase_serving_mc_shards(args, smi: str, work: str, weights: str,
                            batches, key: int, unsharded) -> int:
    """Phase 15's mc-sharded point at full width: ``export_auv_serving_
    artifact(mc_shards=MC_SHARDS)`` from phase 13's file (mc_chunk left at
    its default, all the draws: one stack of NUM_MC / MC_SHARDS draws per
    shard), loaded with the shards all on cuda:0; ``predict_batches``
    over phase 4's patches with exactly MC_SHARDS stacked_sampler launches
    a batch and no other; each batch's logits bit-equal to the one-process
    stacked path (``mc_logits`` through ``gaussian_shift_scale``, one
    chunk, bf16 weights) at the same seeds, its CSV columns equal to that
    path's; kernel #2 through the op ``auv::stacked_sampler`` (seed words
    in device memory) at the shard's shape, NUM_MC / MC_SHARDS draws of
    the full P with bf16 in and out, bit-equal to its plain version, its
    time beside its bound, the plain version and ``torch.normal``. Prints
    export s, load s and patches/s beside the unsharded artifact's
    (``unsharded``). Returns the stacked_sampler launches of the served
    run, and (export s, load s, patches/s, program MB)."""
    from multimodal_auv_torch.bayes.packing import softplus
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.mc import mc_logits
    from multimodal_auv_torch.engine.predict import _mc_outputs
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact
    from multimodal_auv_torch.ops.sampler_times import sustained
    from multimodal_auv_torch.pipelines.inference import pretrained_bundle
    from multimodal_auv_torch.serving import fold_seed, load_predict_artifact

    rows = NUM_MC // MC_SHARDS
    art_dir = os.path.join(work, "artifact_mc_shards")
    reset_launches()
    t0 = time.perf_counter()
    export_auv_serving_artifact(art_dir, batch_size=BATCH,
                                num_mc_samples=NUM_MC,
                                num_classes=NUM_CLASSES,
                                model_weights_path=weights,
                                mc_shards=MC_SHARDS, seed=args.seed)
    t_export = time.perf_counter() - t0
    check_launches("mc-sharded export", {})
    size = os.path.getsize(os.path.join(art_dir, "program.pt2")) / 1e6
    free_cuda()
    t0 = time.perf_counter()
    art = load_predict_artifact(art_dir, devices=["cuda:0"] * MC_SHARDS)
    t_load = time.perf_counter() - t0
    if (art.meta["mc_shards"], art.shard_rows, art.nchunks) != (
            MC_SHARDS, rows, 1):
        raise AssertionError(f"mc-sharded artifact meta {art.meta}, "
                             f"{art.shard_rows} rows x {art.nchunks} chunks")
    list(art.predict_batches(batches, key=key))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = list(art.predict_batches(batches, key=key))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches("mc-sharded artifact", {
        "stacked_sampler": MC_SHARDS * len(batches)})

    bundle = pretrained_bundle(NUM_CLASSES, BNNPriorSpec(), ArchConfig(),
                               args.seed, weights, False,
                               torch.device("cuda"))
    for i, ((m, b, ss, mask), out) in enumerate(zip(batches, outs)):
        seed = fold_seed(key, i)
        cuda_mask = torch.from_numpy(mask).cuda()
        got = art.predict_logits(m, b, ss, key=seed, mask=mask)
        with torch.inference_mode():
            ref = mc_logits(bundle.module, bundle.meta, bundle.post,
                            bundle.batch_stats, normalize_multimodal(
                                *(torch.from_numpy(a).cuda()
                                  for a in (m, b, ss))),
                            torch.Generator().manual_seed(seed), NUM_MC,
                            mc_chunk=NUM_MC, train=True, remat=False,
                            sample_dtype=torch.bfloat16,
                            batch_mask=cuda_mask)
        if got.shape != (NUM_MC, BATCH, NUM_CLASSES) or not torch.equal(
                got, ref):
            raise AssertionError(
                f"mc-sharded batch {i}: logits differ from the one-process "
                f"stacked path, max abs "
                f"{float((got.float() - ref.float()).abs().max())}")
        if not np.array_equal(out["csv_cols"],
                              _mc_outputs(ref)["csv_cols"].cpu().numpy()):
            raise AssertionError(f"mc-sharded batch {i}: CSV columns differ "
                                 f"from the stacked path's")

    # kernel #2 through the op at the shard's shape
    with torch.no_grad():
        mu = bundle.post.mu.detach().to(torch.bfloat16)
        sg = softplus(bundle.post.rho.detach().float()).to(torch.bfloat16)
    del bundle, art
    free_cuda()
    P = mu.numel()
    words = (args.seed + 1515, 0xFFFFFF00)
    seeds = S.seed_tensor(words, "cuda")
    got = S.stacked_draws(mu, sg, seeds, rows, out_dtype=torch.bfloat16)
    want = S.stacked_plain(mu, sg, words, rows, torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"auv::stacked_sampler != plain at {rows} x "
                             f"P={P} bf16")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    counted, calls = S.stacked_exact_calls(mu, sg, seeds, rows)
    if not torch.equal(counted, S.stacked_plain(mu, sg, words, rows,
                                                torch.bfloat16)):
        raise AssertionError("the counted bf16 stacked launch != plain")
    share = calls / S.philox_calls(P, rows)
    del counted
    free_cuda()
    draw = lambda: S.stacked_draws(mu, sg, seeds, rows,
                                   out_dtype=torch.bfloat16)
    ms = cuda_ms(draw, 20)
    held = sustained(draw)
    plain_ms = cuda_ms(lambda: S.stacked_plain(mu, sg, words, rows,
                                               torch.bfloat16), 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mun, sgn = mu.expand(rows, P), sg.expand(rows, P)
    lib_ms = cuda_ms(lambda: torch.normal(mun, sgn, generator=gen), 20)
    b_ms, b_by = bound_ms(2 * P * 2 + 16 + rows * P * 2,
                          (P // 2) * rows * SAMPLER_F32_OPS[False])
    del mu, sg, mun, sgn
    free_cuda()
    e0, l0, r0, _ = unsharded
    log(f"mc-sharded artifact (full width, b{BATCH} x {NUM_MC} MC as "
        f"{MC_SHARDS} shards of {rows} stacked draws on cuda:0, bf16): "
        f"export {t_export:.2f} s, load {t_load:.2f} s, program.pt2 "
        f"{size:.1f} MB, predict_batches {N_SAMPLES} patches in "
        f"{wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s; unsharded "
        f"(chunk 2): export {e0:.2f} s, load {l0:.2f} s, {r0:.3f} "
        f"patches/s [{smi}]; logits bit-equal to the one-process stacked "
        f"path on every batch, CSV columns equal; launches {launches}",
        summary=True)
    log(f"stacked_sampler (bf16_stacked_kernel) via auv::stacked_sampler "
        f"(device seed) at the shard's shape {rows} x P={P}, bf16 in and "
        f"out: == plain bit for bit (max abs err {err}); kernel {ms:.4f} ms "
        f"({held['ms']:.4f} ms a call over {held['calls']} back to back at "
        f"SM {held['sm_mhz']} MHz, {held['watts']} W), plain "
        f"{plain_ms:.3f} ms, torch.normal {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); exact path {calls} of "
        f"{S.philox_calls(P, rows)} Philox calls ({share:.3e}) [{smi}]; "
        f"{philox_note(P, rows)}", summary=True)
    entry = {"name": "stacked_sampler:bf16_stacked_kernel", "route": "cuda",
             "source": "multimodal_auv_torch/csrc/sampling.cu",
             "replaces": "multimodal_auv_tpu/ops/sampling.py:198",
             "launches": launches["stacked_sampler"], "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": lib_ms}
    return launches["stacked_sampler"], (t_export, t_load,
                                         N_SAMPLES / wall, size), entry


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want| (NaN stays NaN)."""
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max())


def _unsharded_logits(bundle, batch, seed: int) -> list:
    """The unsharded packed step's logits (chunk 2) on ``batch``, beside
    which the data-sharded artifact's are reported: them, their
    reduction-order control (the batch halves swapped, the output swapped
    back) and the step with its convolutions run per data shard's rows
    (``_half_batch_conv_logits``)."""
    from multimodal_auv_torch.engine.predict import make_packed_logits_fn
    from multimodal_auv_torch.ops.sampling import chunk_seed_words

    fn = make_packed_logits_fn(bundle, mc_chunk=2)
    seeds = chunk_seed_words(torch.Generator().manual_seed(seed),
                             NUM_MC // 2).cuda()
    swap = [BATCH // 2 + i for i in range(BATCH // 2)] + list(
        range(BATCH // 2))
    m, b, ss, mask = batch
    with torch.inference_mode():
        run = lambda rows: fn(bundle.post, bundle.batch_stats, tuple(
            torch.from_numpy(a[rows]).cuda() for a in (m, b, ss)), seeds,
            torch.from_numpy(mask[rows]).cuda()).float().cpu()
        return [run(slice(None)), run(swap)[:, swap],
                _half_batch_conv_logits(bundle, batch, seed)]


def phase_serving_data_shards(args, smi: str, work: str, batches, key: int,
                              others) -> int:
    """Phase 15's data-sharded point (module docstring), at ResNet-50's
    widths with one bottleneck per stage (PAR_STAGES, as phase 18: the
    full depth's export, load and mesh ranks took ~150 s of the smoke's
    time limit): a published-form file written at that depth from a seed,
    ``export_auv_serving_artifact(data_shards=DATA_SHARDS)`` from it, chunk
    2, loaded with both shards on cuda:0. The first batch: the two
    shards' draws bit-equal, the logits bit-equal to the data=2 mesh step
    of two gloo ranks (``serving_rank``) from the same file at the same
    seed, and a planted fault (``auv::shard_sum`` returning each shard's
    local sums) not; both printed beside the unsharded step's logits at
    that depth (``_unsharded_logits``), which in bf16 do not bound them
    (PERF.md, Findings). Then the timed ``predict_batches`` with exactly
    DATA_SHARDS x 30 split_sampler launches, and
    ``check_composed_micro``. ``others``: the full-depth unsharded and
    mc-sharded artifacts' (export s, load s, patches/s, program MB),
    printed beside. Returns the split_sampler launches of the timed
    run."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.parallel import local_shards as L
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact
    from multimodal_auv_torch.pipelines.inference import pretrained_bundle
    from multimodal_auv_torch.serving import fold_seed, load_predict_artifact

    arch = ArchConfig(stage_sizes=PAR_STAGES)
    weights = os.path.join(work, "pytorch_model_stages.bin")
    src = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                 torch.Generator().manual_seed(args.seed + 52),
                                 arch, device="cuda")
    save_torch_checkpoint(src, weights, published=True)
    del src
    bundle = pretrained_bundle(NUM_CLASSES, BNNPriorSpec(), arch, args.seed,
                               weights, False, torch.device("cuda"))
    unsharded_logits = _unsharded_logits(bundle, batches[0],
                                         fold_seed(key, 0))
    del bundle
    free_cuda()
    art_dir = os.path.join(work, "artifact_data_shards")
    reset_launches()
    t0 = time.perf_counter()
    export_auv_serving_artifact(art_dir, batch_size=BATCH,
                                num_mc_samples=NUM_MC,
                                num_classes=NUM_CLASSES,
                                model_weights_path=weights, arch=arch,
                                mc_chunk=2, data_shards=DATA_SHARDS,
                                seed=args.seed)
    t_export = time.perf_counter() - t0
    check_launches("data-sharded export", {})
    size = os.path.getsize(os.path.join(art_dir, "program.pt2")) / 1e6
    free_cuda()
    t0 = time.perf_counter()
    # the mesh step's ranks run while the artifact loads
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(_run_ranks, 2, "gloo", args, work, "serving",
                            weights)
        art = load_predict_artifact(art_dir,
                                    devices=["cuda:0"] * DATA_SHARDS)
        t_load = time.perf_counter() - t0
        ranks = sorted(ranks.result(), key=lambda r: r["rank"])
    mesh = torch.cat([torch.tensor(r["logits"]) for r in ranks], dim=1)
    t_mesh = time.perf_counter() - t0
    if (art.data_shards, art.mc_shards, art.nchunks) != (
            DATA_SHARDS, 1, NUM_MC // 2):
        raise AssertionError(f"data-sharded artifact meta {art.meta}, "
                             f"{art.nchunks} chunks")
    m, b, ss, mask = batches[0]
    first = lambda: art.predict_logits(m, b, ss, key=fold_seed(key, 0),
                                       mask=mask).float().cpu()
    try:
        # the first batch (which warms the half-batch shapes up) with its
        # draws recorded, keyed by their seed words (one row per chunk,
        # the same on both shards)
        draws, launch = {}, S._launch

        def recording(name, mu, scale, seed, *a, **kw):
            out = launch(name, mu, scale, seed, *a, **kw)
            draws.setdefault(tuple(seed.tolist()), []).append(out)
            return out

        S._launch = recording
        try:
            got = first()
        finally:
            S._launch = launch
        pairs = list(draws.values())
        if (len(pairs) != NUM_MC // 2
                or any(len(p) != DATA_SHARDS for p in pairs)
                or not all(torch.equal(p[0], q) for p in pairs
                           for q in p[1:])):
            raise AssertionError(f"data shards' draws differ: "
                                 f"{[len(p) for p in pairs]} launches per "
                                 f"chunk")
        del draws, pairs
        free_cuda()
        if got.shape != mesh.shape or not torch.equal(got, mesh):
            raise AssertionError(
                f"data-sharded logits != the data=2 mesh step's: "
                f"{tuple(got.shape)} vs {tuple(mesh.shape)}, "
                f"{_rel_err(got, mesh) if got.shape == mesh.shape else ''}")
        real_sum = L.ShardGroup.sum
        L.ShardGroup.sum = lambda self, index, x, turn=None: x.clone()
        try:
            bad = first()
        finally:
            L.ShardGroup.sum = real_sum
        if torch.equal(bad, mesh):
            raise AssertionError("the local-sums fault equals the data=2 "
                                 "mesh step's logits")

        reset_launches()
        L.COUNTS["rendezvous"] = 0
        t0 = time.perf_counter()
        list(art.predict_batches(batches, key=key))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches("data-sharded artifact", {
            "split_sampler": DATA_SHARDS * len(batches) * NUM_MC // 2})
        rendezvous = L.COUNTS["rendezvous"] // len(batches)
    finally:
        art.close()
    del art
    free_cuda()
    ref, control, half_conv = unsharded_logits
    beside = "; ".join(
        f"{name}: export {e:.2f} s, load {ld:.2f} s, {mb:.1f} MB, {r:.3f} "
        f"patches/s" for name, (e, ld, r, mb) in zip(
            ("unsharded (chunk 2)", f"mc_shards={MC_SHARDS}"), others))
    log(f"data-sharded artifact (ResNet-50 widths, one bottleneck per "
        f"stage, b{BATCH} x {NUM_MC} MC, chunk "
        f"2, as {DATA_SHARDS} shards of {BATCH // DATA_SHARDS} rows on "
        f"cuda:0, bf16): export {t_export:.2f} s, load {t_load:.2f} s, "
        f"program.pt2 {size:.1f} MB, predict_batches {N_SAMPLES} patches in "
        f"{wall:.3f} s = {N_SAMPLES / wall:.3f} patches/s, {rendezvous} BN "
        f"rendezvous a batch; {beside} [{smi}]; launches {launches}; the "
        f"first batch: the shards' draws bit-equal, logits bit-equal to the "
        f"data=2 mesh step of two gloo ranks ({t_mesh:.1f} s), the "
        f"local-sums fault not; off the unsharded step's by "
        f"{_rel_err(got, ref):.3e} of the largest logit (the fault "
        f"{_rel_err(bad, ref):.3e}), its reduction-order control "
        f"{_rel_err(control, ref):.3e}, the unsharded step with its "
        f"convolutions run per shard's rows {_rel_err(half_conv, ref):.3e}",
        summary=True)
    check_composed_micro(smi, work)
    return launches["split_sampler"]


def check_composed_micro(smi: str, work: str) -> None:
    """A (2 data x 2 mc)-sharded micro() artifact exported on the card and
    the same export on the CPU (the same seeds, the stacked sampler's
    draws bit-equal to its plain version): predicted classes equal, logits
    within DS_MICRO_RTOL of the largest (f32 forwards, TF32 off)."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    rng = np.random.default_rng(15)
    u8 = [rng.integers(0, 256, (BATCH, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    mask = np.array([1, 1, 1, 0], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        bundle = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                        torch.Generator().manual_seed(0),
                                        ArchConfig.micro(), device=dev)
        d = os.path.join(work, f"composed_micro_{dev}")
        export_predict_artifact(bundle, d, batch_size=BATCH,
                                num_mc_samples=4, image_size=32,
                                data_shards=2, mc_shards=2)
        art = load_predict_artifact(d, devices=[dev] * 4)
        try:
            out[dev] = (art.predict_logits(*u8, key=3, mask=mask).float()
                        .cpu(), art.predict(*u8, key=3, mask=mask))
        finally:
            art.close()
    err = _rel_err(out["cuda"][0], out["cpu"][0])
    if not (np.array_equal(out["cuda"][1]["predicted"],
                           out["cpu"][1]["predicted"])
            and err <= DS_MICRO_RTOL):
        raise AssertionError(f"composed micro() artifact card vs CPU: "
                             f"logits {err:.3e} of the largest")
    log(f"(2 data x 2 mc)-sharded micro() artifact, card == CPU: classes "
        f"equal, logits {err:.3e} of the largest (gate {DS_MICRO_RTOL}) "
        f"[{smi}]", summary=True)


def check_dvp_kernel(mean, scale, seed, smi: str) -> None:
    """Phase 16 (a): kernel #1 at the DVP step's draw shape (the vectors
    the step handed it) against ``split_plain`` bit for bit; its time
    beside its bound, the plain version and one ``torch.normal`` call over
    the same work."""
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms

    f32, n = torch.float32, mean.numel()
    words = tuple(seed.tolist())
    got = S.split_draws(mean, scale, seed, NUM_MC, out_dtype=f32)
    want = torch.stack(S.split_plain(mean, scale, words, NUM_MC, f32))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"split_sampler != plain at the DVP shape "
                             f"(n={n}, {NUM_MC} draws f32): max abs err "
                             f"{err}")
    del got, want
    ms = cuda_ms(lambda: S.split_draws(mean, scale, seed, NUM_MC,
                                       out_dtype=f32), 50)
    plain_ms = cuda_ms(lambda: S.split_plain(mean, scale, words, NUM_MC,
                                             f32), 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib_ms = cuda_ms(lambda: torch.normal(mean.expand(NUM_MC, n),
                                          scale.expand(NUM_MC, n),
                                          generator=gen), 50)
    nbytes = 2 * n * 4 + NUM_MC * n * 4
    b_ms, b_by = bound_ms(nbytes, (n // 2) * NUM_MC * SAMPLER_F32_OPS[False])
    log(f"split_sampler at the DVP shape (n={n}, {NUM_MC} draws, f32 out, "
        f"f32 noise, seed from device memory) == plain bit for bit; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch.normal {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e9:.3f} GB) [{smi}]; "
        f"{philox_note(n, NUM_MC)}")


def check_dvp_card_vs_cpu() -> None:
    """Phase 16 (b): the micro() DVP logits on the card and on the CPU at
    the same seed words. The draws' noise is bit-equal; the f32 moment
    passes (TF32 off) differ only in summation order and libm's last
    bits, so the logits agree to 1e-4 absolute."""
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.moment import make_dvp_logits_fn
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )

    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    seeds = torch.tensor([[12345, 678]], dtype=torch.int64)
    logits = []
    for dev in ("cuda", "cpu"):
        b = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device=dev)
        fn = make_dvp_logits_fn(b, NUM_MC, packed_inputs=True)
        with torch.inference_mode():
            logits.append(fn(b.post, b.batch_stats,
                             tuple(torch.from_numpy(a).to(dev) for a in u8),
                             seeds.to(dev)).cpu())
    err = float((logits[0] - logits[1]).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"DVP card vs CPU at micro(): logits max abs "
                             f"err {err}")
    log(f"DVP card == CPU at micro(): ({NUM_MC}, 3, {NUM_CLASSES}) logits "
        f"max abs err {err:.2e} (limit 1e-4)")


def phase_dvp(args, smi: str, work: str, weights: str,
              mc_rate: float) -> int:
    """Phase 16: single-pass DVP at full width (see the module docstring).
    Returns the phase's split_sampler launches on its paths."""
    import multimodal_auv_torch.engine.moment as M
    from multimodal_auv_torch import cli
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.predict import (
        make_packed_predict_step,
        multimodal_predict_and_save_packed,
    )
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.pipelines.inference import pretrained_bundle
    from multimodal_auv_torch.serving import fold_seed, load_predict_artifact

    t_phase = time.perf_counter()
    bundle = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(),
                                    torch.Generator().manual_seed(args.seed),
                                    ArchConfig(), device="cuda")
    t0 = time.perf_counter()
    spread = M.posterior_spread(bundle.post, bundle.meta)
    t_spread = time.perf_counter() - t0
    step, mode = M.make_dvp_predict_step(
        bundle, NUM_MC, on_excess="mc", packed_inputs=True, mc_chunk=2,
        return_mode=True, spread=spread)
    if mode != "dvp":
        raise AssertionError(f"MOPED spread {spread}: mode {mode}")
    packed = os.path.join(work, "packed")  # phase 4's set
    csv_path = os.path.join(OUT_DIR, "dvp_predictions.csv")
    n_batches = -(-N_SAMPLES // BATCH)

    def run(s):
        multimodal_predict_and_save_packed(
            bundle, packed, csv_path, num_mc_samples=NUM_MC,
            batch_size=BATCH, generator=torch.Generator().manual_seed(
                args.seed + 1), step=s, device="cuda")
        torch.cuda.synchronize()

    drawn, draws = [], M.split_draws

    def recorded(mean, scale, seed, num_draws, **kw):
        if not drawn:  # the first batch's vectors, for (a)
            drawn.append((mean, scale, seed.clone()))
        return draws(mean, scale, seed, num_draws, **kw)

    M.split_draws = recorded
    try:
        t0 = time.perf_counter()
        run(step)  # warm-up: cuDNN's algorithm choice, allocator growth
        t_warm = time.perf_counter() - t0
    finally:
        M.split_draws = draws
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run(step)
    launches = check_launches("DVP path", {"split_sampler": n_batches})
    n_launches = launches["split_sampler"]
    check_csv(csv_path)
    walls = []
    for _ in range(DVP_REPEATS):
        t0 = time.perf_counter()
        run(step)
        walls.append(time.perf_counter() - t0)
    log(f"DVP path (spread {spread:.6f}, measured in {t_spread:.3f} s): "
        f"{DVP_REPEATS} x {N_SAMPLES} patches, {n_batches} batches of "
        f"{BATCH} x {NUM_MC} feature samples a pass, in {sum(walls):.3f} s "
        f"= {DVP_REPEATS * N_SAMPLES / sum(walls):.3f} patches/s (passes "
        f"{min(walls):.3f}-{max(walls):.3f} s; MC, phase 4, this run: "
        f"{mc_rate:.3f}) [{smi}]; warm-up {t_warm:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches of "
        f"the counted pass {launches}")
    batches, valid = _padded_batches(packed)
    main, bathy, sss, mask = batches[0]
    x = tuple(torch.from_numpy(a).cuda() for a in (main, bathy, sss))
    mk = torch.from_numpy(mask).cuda()
    if args.profile:
        gen = torch.Generator().manual_seed(args.seed)
        profile_run(f"one DVP batch of {BATCH} x {NUM_MC}",
                    "profile_dvp.txt",
                    lambda: step(bundle.post, bundle.batch_stats, x, gen, mk))

    with torch.inference_mode():
        check_dvp_kernel(*drawn[0], smi)
    del drawn
    free_cuda()
    check_dvp_card_vs_cpu()

    # (f) fidelity at the MOPED spread: printed, not gated (random weights
    # give near-uniform outputs; a gate waits for the published weights)
    mc_step = make_packed_predict_step(bundle, NUM_MC, mc_chunk=2)
    outs = [s(bundle.post, bundle.batch_stats, x,
              torch.Generator().manual_seed(args.seed + 2), mk)
            for s in (step, mc_step)]
    n = valid[0]
    dvp, mc = ({k: v.cpu().numpy()[:n] for k, v in o.items()
                if k != "csv_cols"} for o in outs)
    log(f"DVP vs {NUM_MC}-draw MC at spread {spread:.4f} (batch 0, {n} "
        f"rows): argmax agreement "
        f"{float(np.mean(dvp['predicted'] == mc['predicted'])):.2f}, max "
        f"|d mean_prob| {np.abs(dvp['mean_prob'] - mc['mean_prob']).max():.3e}"
        f", predictive u DVP {dvp['predictive_uncertainty'].mean():.3e} MC "
        f"{mc['predictive_uncertainty'].mean():.3e} (random weights; "
        f"printed, not gated)")
    del outs, mc_step, x, mk

    # (d) the guardrail: sigma = 0.5 |mu| over the real region
    n_real = bundle.meta.n_real
    with torch.no_grad():
        bundle.post.rho[:n_real] = torch.log(torch.expm1(torch.clamp_min(
            0.5 * bundle.post.mu[:n_real].abs(), 1e-12)))
    wide = M.posterior_spread(bundle.post, bundle.meta)
    fallback, mode = M.make_dvp_predict_step(
        bundle, NUM_MC, on_excess="mc", packed_inputs=True, mc_chunk=2,
        return_mode=True, spread=wide)
    if mode != "mc" or not wide > M.DVP_SPREAD_THRESHOLD:
        raise AssertionError(f"spread {wide}: mode {mode}, want mc")
    reset_launches()
    run(fallback)
    launches = check_launches("DVP guardrail fallback",
                              {"split_sampler": n_batches * NUM_MC // 2})
    n_launches += launches["split_sampler"]
    check_csv(csv_path)
    log(f"DVP guardrail: spread {wide:.4f} > {M.DVP_SPREAD_THRESHOLD} -> "
        f"mode {mode}, the exact MC step; launches {launches}")
    del bundle, step, fallback
    free_cuda()

    # (e) export-serving --dvp from phase 13's file
    art_dir = os.path.join(work, "artifact_dvp")
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["export-serving", "--output_dir", art_dir, "--batch_size",
                   str(BATCH), "--num_mc_samples", str(NUM_MC),
                   "--model_weights", weights, "--dvp", "--device", "cuda"])
    t_export = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"export-serving --dvp exited {rc}")
    check_launches("DVP export", {})
    size = os.path.getsize(os.path.join(art_dir, "program.pt2")) / 1e6
    free_cuda()
    t0 = time.perf_counter()
    art = load_predict_artifact(art_dir)
    t_load = time.perf_counter() - t0
    if (art.meta["mode"] != "dvp" or art.nchunks != 1
            or art.mc_chunk != NUM_MC):
        raise AssertionError(f"DVP artifact meta {art.meta}, chunk "
                             f"{art.mc_chunk} x {art.nchunks}")
    key = args.seed + 16
    list(art.predict_batches(batches, key=key))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    outs = list(art.predict_batches(batches, key=key))
    torch.cuda.synchronize()
    launches = check_launches("DVP artifact",
                              {"split_sampler": len(batches)})
    n_launches += launches["split_sampler"]
    t0 = time.perf_counter()
    for _ in range(DVP_REPEATS):
        list(art.predict_batches(batches, key=key))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bundle = pretrained_bundle(NUM_CLASSES, BNNPriorSpec(), ArchConfig(), 0,
                               weights, False, torch.device("cuda"))
    step = M.make_dvp_predict_step(bundle, NUM_MC, packed_inputs=True)
    m, b, ss, mask = batches[0]
    first = art.predict_logits(m, b, ss, key=fold_seed(key, 0),
                               mask=mask).cpu()
    for i, ((m, b, ss, mask), out) in enumerate(zip(batches, outs)):
        ref = step(bundle.post, bundle.batch_stats,
                   tuple(torch.from_numpy(a).cuda() for a in (m, b, ss)),
                   torch.Generator().manual_seed(fold_seed(key, i)),
                   torch.from_numpy(mask).cuda())
        for k in ("predicted", "csv_cols", "mean_prob"):
            if not np.array_equal(out[k], ref[k].cpu().numpy()):
                raise AssertionError(f"DVP artifact batch {i}: {k} differs "
                                     f"from the in-process DVP step")
    log(f"DVP artifact (export-serving --dvp, full width, b{BATCH} x "
        f"{NUM_MC}): export {t_export:.2f} s (bundle and import of the "
        f"published file included), load {t_load:.2f} s, program.pt2 "
        f"{size:.1f} MB, meta mode {art.meta['mode']} spread "
        f"{art.meta['posterior_spread']}; predict_batches {DVP_REPEATS} x "
        f"{N_SAMPLES} patches in {wall:.3f} s = "
        f"{DVP_REPEATS * N_SAMPLES / wall:.3f} patches/s "
        f"[{smi}]; bit-equal to the in-process DVP step at the same seeds; "
        f"launches {launches}")
    del art, bundle, step
    free_cuda()
    n_launches += phase_dvp_data_shards(
        args, smi, work, weights, batches, key, first,
        (t_export, t_load, DVP_REPEATS * N_SAMPLES / wall, size))
    log(f"phase 16 (DVP): {time.perf_counter() - t_phase:.1f} s")
    return n_launches


def phase_dvp_data_shards(args, smi: str, work: str, weights: str, batches,
                          key: int, unsharded_logits, unsharded) -> int:
    """Phase 16 (f), the data-sharded DVP artifact at full width (module
    docstring): ``export-serving --dvp --data_shards DATA_SHARDS`` from
    phase 13's file, loaded with both shards on cuda:0. The first batch:
    the shards' draws bit-equal, the logits bit-equal to the DVP logits on
    the data=2 mesh of two gloo ranks (``serving_rank``'s "serving_dvp"
    job) from the same file at the same seed words, a planted local-sums
    fault and a planted wrong-rows fault not. Then ``predict_batches``
    with exactly DATA_SHARDS split_sampler launches a batch and the
    program's rendezvous a batch, and DVP_REPEATS timed passes.
    ``unsharded_logits``: (e)'s first batch; ``unsharded``: (e)'s export
    s, load s, patches/s and program MB, printed beside. Returns the
    split_sampler launches of the counted run."""
    from multimodal_auv_torch import cli
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.parallel import local_shards as L
    from multimodal_auv_torch.serving import fold_seed, load_predict_artifact

    art_dir = os.path.join(work, "artifact_dvp_data_shards")
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["export-serving", "--output_dir", art_dir, "--batch_size",
                   str(BATCH), "--num_mc_samples", str(NUM_MC),
                   "--model_weights", weights, "--dvp", "--data_shards",
                   str(DATA_SHARDS), "--device", "cuda"])
    t_export = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"export-serving --dvp --data_shards exited "
                             f"{rc}")
    check_launches("data-sharded DVP export", {})
    size = os.path.getsize(os.path.join(art_dir, "program.pt2")) / 1e6
    free_cuda()
    t0 = time.perf_counter()
    # the mesh's ranks run while the artifact loads
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(_run_ranks, 2, "gloo", args, work, "serving_dvp",
                            weights)
        art = load_predict_artifact(art_dir,
                                    devices=["cuda:0"] * DATA_SHARDS)
        t_load = time.perf_counter() - t0
        ranks = sorted(ranks.result(), key=lambda r: r["rank"])
    mesh = torch.cat([torch.tensor(r["logits"]) for r in ranks], dim=1)
    t_mesh = time.perf_counter() - t0
    if (art.meta["mode"], art.data_shards, art.mc_shards, art.nchunks) != (
            "dvp", DATA_SHARDS, 1, 1):
        raise AssertionError(f"data-sharded DVP artifact meta {art.meta}, "
                             f"{art.nchunks} chunks")
    nodes = [str(n.target) for n in art._programs[art.device].graph.nodes]
    meets = sum(t in ("auv.shard_sum.default", "auv.shard_gather.default")
                for t in nodes)
    if (nodes.count("auv.shard_gather.default"),
            nodes.count("auv.shard_rows.default")) != (2, 1):
        raise AssertionError("the data-sharded DVP program holds "
                             f"{nodes.count('auv.shard_gather.default')} "
                             f"gathers, {nodes.count('auv.shard_rows.default')}"
                             f" own-rows slices (want 2, 1)")
    m, b, ss, mask = batches[0]
    first = lambda: art.predict_logits(m, b, ss, key=fold_seed(key, 0),
                                       mask=mask).cpu()
    try:
        # the first batch (which warms the half-batch shapes up) with each
        # shard's draws recorded
        draws, launch = [], S._launch

        def recording(name, mu, scale, seed, *a, **kw):
            out = launch(name, mu, scale, seed, *a, **kw)
            draws.append(out)
            return out

        S._launch = recording
        try:
            got = first()
        finally:
            S._launch = launch
        if (len(draws) != DATA_SHARDS
                or not all(torch.equal(draws[0], d) for d in draws[1:])):
            raise AssertionError(f"data shards' DVP draws differ "
                                 f"({len(draws)} launches)")
        del draws
        if got.shape != mesh.shape or not torch.equal(got, mesh):
            raise AssertionError(
                f"data-sharded DVP logits != the data=2 mesh's: "
                f"{tuple(got.shape)} vs {tuple(mesh.shape)}, "
                f"{_rel_err(got, mesh) if got.shape == mesh.shape else ''}")
        real_sum, rows_of = L.ShardGroup.sum, L.rows_of
        L.ShardGroup.sum = lambda self, index, x, turn=None: x.clone()
        try:
            bad_sums = first()
        finally:
            L.ShardGroup.sum = real_sum
        L.rows_of = lambda x, n, dim, i: rows_of(x, n, dim, (i + 1) % n)
        try:
            bad_rows = first()
        finally:
            L.rows_of = rows_of
        for name, bad in (("local-sums", bad_sums), ("wrong-rows", bad_rows)):
            if torch.equal(bad, mesh):
                raise AssertionError(f"the {name} fault equals the data=2 "
                                     f"mesh's DVP logits")

        reset_launches()
        L.COUNTS["rendezvous"] = 0
        list(art.predict_batches(batches, key=key))
        torch.cuda.synchronize()
        launches = check_launches("data-sharded DVP artifact", {
            "split_sampler": DATA_SHARDS * len(batches)})
        if L.COUNTS["rendezvous"] != meets * len(batches):
            raise AssertionError(
                f"{L.COUNTS['rendezvous']} rendezvous over {len(batches)} "
                f"batches, the program meets {meets} times a batch")
        t0 = time.perf_counter()
        for _ in range(DVP_REPEATS):
            list(art.predict_batches(batches, key=key))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        art.close()
    del art
    free_cuda()
    e, ld, r, mb = unsharded
    log(f"data-sharded DVP artifact (export-serving --dvp --data_shards "
        f"{DATA_SHARDS}, full width, b{BATCH} x {NUM_MC} as {DATA_SHARDS} "
        f"shards of {BATCH // DATA_SHARDS} rows on cuda:0): export "
        f"{t_export:.2f} s, load {t_load:.2f} s, program.pt2 {size:.1f} MB, "
        f"predict_batches {DVP_REPEATS} x {N_SAMPLES} patches in {wall:.3f} "
        f"s = {DVP_REPEATS * N_SAMPLES / wall:.3f} patches/s, {meets} "
        f"rendezvous a batch; unsharded DVP artifact: export {e:.2f} s, load "
        f"{ld:.2f} s, {mb:.1f} MB, {r:.3f} patches/s [{smi}]; launches "
        f"{launches}; the first batch: the shards' draws bit-equal, logits "
        f"bit-equal to the data=2 mesh's DVP logits of two gloo ranks "
        f"({t_mesh:.1f} s), the local-sums fault (off the mesh by "
        f"{_rel_err(bad_sums, mesh):.3e} of the largest logit) and the "
        f"wrong-rows fault ({_rel_err(bad_rows, mesh):.3e}) not; off the "
        f"unsharded DVP artifact's by {_rel_err(got, unsharded_logits):.3e}",
        summary=True)
    return launches["split_sampler"]


def check_probe_kernels(P_full: int) -> None:
    """Every kernel the RNG-split probe launches (its three and the eps
    kernel, its ``bm``) against its plain version, bit for bit: at the
    small and quarter-ending P's (1-3 draws) and the full model's P (2
    draws), f32 and bf16 out (eps_fast: bf16 only), and at the shapes the
    probe runs: its P at its 20 draws in bf16, and at the fidelity check's
    2 draws in f32. Raises on the first difference."""
    from multimodal_auv_torch.ops import probe_rng_split as PR
    from multimodal_auv_torch.ops.sampler_times import same_bits

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
            if not same_bits(got, want):
                e = float((got.float() - want.float()).abs().max())
                raise AssertionError(f"{name} != plain ({dt}, P={P}, "
                                     f"{n} draws): max abs err {e}")
            del got, want
    log(f"rng_bits, rng_bmlite, eps_fast, eps == plain bit for bit at "
        f"{', '.join(f'P={P} x {n} {str(dt)[6:]}' for P, n, dt in cases)}")


def check_noise_parts() -> None:
    """The device functions every noise kernel draws through (the radius
    of b1, the angle's sin and cos of b2) on all 2^24 words, each
    polynomial set, against the plain versions on the card, bits compared:
    the exact forms of the Box-Muller (csrc/sampling.cu) and its division
    and square root without range checks, over every input they meet.
    Then the bf16 stacked kernel's approximate radius and angle over the
    same words against the f32 ones: every deviation within the bracket
    constants the library holds (``sampler_times.check_bracket``, which
    raises otherwise; the constants are never widened to pass)."""
    from multimodal_auv_torch.ops.sampler_times import (
        check_bracket,
        check_parts,
    )

    check_parts()
    log("noise_parts (radius, sin, cos of all 2^24 words; f32, fast and "
        "lite polynomials) == plain bit for bit")
    b = check_bracket()
    log(f"bf16 stacked kernel's bracket over all 2^24 words: max |r' - r| "
        f"{b['max_dev_r']:.3e}, max |sin' - sin|, |cos' - cos| "
        f"{b['max_dev_sc']:.3e}; every deviation within the library's "
        f"constants (E_sc {b['library'][1]:.3e} >= {b['need_sc']:.3e} "
        f"needed)")


def log_sass_counts() -> None:
    """Per kernel of the built library: its draw loop's SASS instructions
    per Box-Muller pair, by class, and its registers (ops/sass.py)."""
    from multimodal_auv_torch.ops import kernels, sass

    counts = sass.library_counts(kernels.build("sampling").path,
                                 BUILD_LOGS.get("sampling", ""))
    for name, c in counts.items():
        log(f"SASS {name}: {c['per_pair_total']:.2f} instructions per pair "
            f"({c['instructions']} for {c['pairs']} pairs), "
            f"{c.get('registers', '?')} registers; "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["per_pair"].items()))


def phase_probe(smi: str, P_full: int) -> list:
    """The RNG-split probe (``multimodal_auv_torch.ops.probe_rng_split``)
    as a phase: its kernels against their plain versions, then its run at
    the TPU probe's geometry with exact launch counts; times of each probe
    kernel at one draw beside its plain version, ``torch.randn`` and its
    bound. Returns their kernels-line entries; their max abs error is 0,
    since any difference from the plain versions raises."""
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms
    from multimodal_auv_torch.ops import probe_rng_split as PR

    check_noise_parts()
    check_probe_kernels(P_full)
    log_sass_counts()
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


def _overlap_share(fn):
    """One profiled call of ``fn`` (after an unprofiled one): the share of
    the sampler kernels' device time that overlaps another kernel, and
    the number of sampler kernels seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    samplers = [(a, b) for a, b, n in kern if "sampler_kernel" in n]
    merged = []
    for a, b in sorted((a, b) for a, b, n in kern
                       if "sampler_kernel" not in n):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in samplers)
    over = sum(max(0, min(b, hi) - max(a, lo))
               for a, b in samplers for lo, hi in merged)
    return (over / total if total else 0.0), len(samplers)


def phase_variants(args, smi: str, bundle, work: str) -> dict:
    """Phase 19: the MC variants and the rest of training at full width
    (see the module docstring). Returns the launches of #1-#3 on its
    paths (the comparisons' reference runs not counted)."""
    from types import SimpleNamespace

    from multimodal_auv_torch.bayes.packing import PackedPosterior, softplus
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine import checkpointing as ckpt
    from multimodal_auv_torch.engine import mc as MC
    from multimodal_auv_torch.engine.optim import (
        BayesTrainState,
        make_optimizer,
    )
    from multimodal_auv_torch.engine.predict import (
        make_packed_logits_fn,
        make_packed_predict_step,
        make_predict_step,
        multimodal_predict_and_save_packed,
    )
    from multimodal_auv_torch.engine.steps import make_train_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
        make_unimodal_bundle,
        multimodal_module,
    )
    from multimodal_auv_torch.ops import sampling as S
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal
    from multimodal_auv_torch.ops.probe_rng_split import cuda_ms

    t_phase = time.perf_counter()
    bf16, spec, meta = torch.bfloat16, BNNPriorSpec(), bundle.meta
    on_path = {"split_sampler": 0, "stacked_sampler": 0, "eps": 0}

    def counted(label, want, fn, path=True):
        """fn() with the launch counts set to 0 before and checked after
        (``want``: a dict, or a function of fn's result giving one)."""
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = check_launches(f"phase 19 {label}",
                             want(out) if callable(want) else want)
        if path:
            for k in on_path:
                on_path[k] += got.get(k, 0)
        return out

    packed = os.path.join(work, "packed")  # phase 4's set
    batches = [([torch.from_numpy(a).cuda() for a in b[:3]],
                torch.from_numpy(b[3]).cuda().bool())
               for b in _padded_batches(packed)[0]]
    n_batches = len(batches)
    u8, mask = batches[0]

    # (a) pipelined: the split path's draws with chunk k + 1 sampled on a
    # second stream
    seeds = S.chunk_seed_words(torch.Generator().manual_seed(args.seed + 19),
                               NUM_MC // 2).cuda()
    with torch.inference_mode():
        logits = [make_packed_logits_fn(bundle, mc_chunk=2, pipelined=p)(
            bundle.post, bundle.batch_stats, u8, seeds, mask)
            for p in (False, True)]
    torch.cuda.synchronize()
    if not torch.equal(logits[0], logits[1]):
        raise AssertionError(
            f"pipelined logits != split: max abs "
            f"{float((logits[0].float() - logits[1].float()).abs().max())}")
    del logits
    steps = {p: make_packed_predict_step(bundle, NUM_MC, pipelined=p)
             for p in (False, True)}
    csvs = {p: os.path.join(work, f"pipelined{int(p)}.csv")
            for p in (False, True)}

    def run(p, csv_path):
        multimodal_predict_and_save_packed(
            bundle, packed, csv_path, num_mc_samples=NUM_MC,
            batch_size=BATCH,
            generator=torch.Generator().manual_seed(args.seed + 1),
            step=steps[p], device="cuda")

    run(True, csvs[True])  # warm-up of the side stream's path
    counted("pipelined", {"split_sampler": n_batches * NUM_MC // 2},
            lambda: run(True, csvs[True]))
    run(False, csvs[False])
    with open(csvs[True], "rb") as f1, open(csvs[False], "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("pipelined CSV != split CSV")
    check_csv(csvs[True])
    walls = {False: [], True: []}
    for p in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(p, os.path.join(work, "pipelined_timed.csv"))
        torch.cuda.synchronize()
        walls[p].append(time.perf_counter() - t0)
    rate = {p: [N_SAMPLES / w for w in ws] for p, ws in walls.items()}
    log(f"pipelined: logits == split bit for bit (b{BATCH} x {NUM_MC}, "
        f"chunk 2), CSV byte-equal, {n_batches * NUM_MC // 2} split "
        f"launches; {min(rate[True]):.3f}-{max(rate[True]):.3f} patches/s "
        f"against split {min(rate[False]):.3f}-{max(rate[False]):.3f} "
        f"(timed pipelined, split, split, pipelined) [{smi}]", summary=True)
    if args.profile:
        share, n = _overlap_share(lambda: steps[True](
            bundle.post, bundle.batch_stats, u8,
            torch.Generator().manual_seed(args.seed), mask))
        log(f"pipelined b{BATCH} batch: {n} split kernels, {share:.3f} of "
            f"their device time overlaps a kernel of the current stream",
            summary=True)
    del steps

    # (b) antithetic: each draw with its mirror, the stacked sampler (#2)
    # bf16 in and out, one draw a chunk
    anti = make_predict_step(bundle, NUM_MC, antithetic=True)

    def run_anti():
        gen = torch.Generator().manual_seed(args.seed + 1)
        with torch.inference_mode():
            return [anti(bundle.post, bundle.batch_stats,
                         normalize_multimodal(*b_u8), gen, b_mask)
                    for b_u8, b_mask in batches]

    run_anti()  # warm-up
    t0 = time.perf_counter()
    outs = counted("antithetic",
                   {"stacked_sampler": n_batches * NUM_MC // 2}, run_anti)
    wall = time.perf_counter() - t0
    probs = torch.cat([o["mean_prob"][m].float()
                       for o, (_, m) in zip(outs, batches)])
    if not (torch.isfinite(probs).all() and torch.allclose(
            probs.sum(1), torch.ones(len(probs), device="cuda"),
            atol=1e-2)):
        raise AssertionError(f"antithetic outputs: {probs}")
    with torch.inference_mode():
        capture = SimpleNamespace(unpack=lambda w, det: w)
        rows = MC.mc_logits(lambda w, bs, *a, **k: w[None].float(), capture,
                            bundle.post, None, [],
                            torch.Generator().manual_seed(args.seed + 191),
                            2, mc_chunk=1, remat=False, sample_dtype=bf16,
                            antithetic=True)[:, 0]
        (seed,) = S.chunk_seeds(torch.Generator().manual_seed(
            args.seed + 191), 1)
        mu = bundle.post.mu.detach().to(bf16)
        sg = softplus(bundle.post.rho.detach().float()).to(bf16)
        w = S.stacked_plain(mu, sg, seed, 1, bf16)[0]
        mirror = (2.0 * mu.float() - w.float()).to(bf16)
        if not (torch.equal(rows[0], w.float())
                and torch.equal(rows[1], mirror.float())):
            raise AssertionError("antithetic rows != [w; 2 mu - w] of the "
                                 "plain sampler")
    del rows, w, mirror
    rng = np.random.default_rng(0)
    x = [rng.standard_normal((3, 32, 32, c)).astype(np.float32)
         for c in (3, 3, 1)]
    cols = []
    for dev in ("cuda", "cpu"):
        b = make_multimodal_bundle(NUM_CLASSES, spec,
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device=dev)
        out = make_predict_step(b, 4, antithetic=True)(
            b.post, b.batch_stats, [torch.from_numpy(a).to(dev) for a in x],
            torch.Generator().manual_seed(1),
            torch.tensor([True, True, False], device=dev))
        cols.append(out["csv_cols"].cpu().numpy()[:, :2])
    err = float(np.abs(cols[0][1:] - cols[1][1:]).max())
    if not (np.array_equal(cols[0][0], cols[1][0]) and err < 1e-4):
        raise AssertionError(f"antithetic card vs CPU at micro(): {cols}")
    P = mu.numel()
    with torch.no_grad():
        got, calls = S.stacked_exact_calls(mu, sg, (1, 2), 1)
        if not torch.equal(got, S.stacked_plain(mu, sg, (1, 2), 1, bf16)):
            raise AssertionError("bf16 stacked kernel != plain at one draw")
        del got
        ms = cuda_ms(lambda: S.gaussian_shift_scale(mu, sg, (1, 2), 1,
                                                    out_dtype=bf16), 50)
        plain_ms = cuda_ms(lambda: S.stacked_plain(mu, sg, (1, 2), 1, bf16),
                           3)
        gen = torch.Generator(device="cuda").manual_seed(0)
        lib_ms = cuda_ms(lambda: torch.normal(
            mu.expand(1, P), sg.expand(1, P), generator=gen), 50)
    b_ms, b_by = bound_ms(6 * P, (P // 2) * SAMPLER_F32_OPS[False])
    log(f"antithetic: {N_SAMPLES / wall:.3f} patches/s (b{BATCH} x {NUM_MC}"
        f", {NUM_MC // 2} sampled draws + mirrors a batch), "
        f"{n_batches * NUM_MC // 2} stacked launches; mirror rows == "
        f"(2 mu - w) in f32 cast to bf16 bit for bit at P={P}; card == CPU "
        f"at micro(): classes equal, uncertainty max abs err {err:.2e}; "
        f"stacked_sampler bf16 in and out, 1 draw (bf16_stacked_kernel, "
        f"== plain, exact path {calls / S.philox_calls(P, 1):.3e} of the "
        f"calls): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"torch.normal {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
        f"[{smi}]", summary=True)
    del anti, outs, mu, sg
    free_cuda()

    # (c) per-draw remat: b12 x 20 in chunks of 10, f32 posterior
    rng = np.random.default_rng(args.seed + 19)
    tin = [torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BATCH, IMAGE, IMAGE, c), dtype=np.uint8)).cuda()
        for c in (3, 3, 1)]
    tlab = torch.from_numpy(rng.integers(0, NUM_CLASSES, TRAIN_BATCH)).cuda()
    tmask = torch.ones(TRAIN_BATCH, device="cuda")

    def fresh(src=bundle):
        p = src.post
        post = PackedPosterior(p.mu.detach().clone(), p.rho.detach().clone(),
                               _clone_tree(p.det))
        return BayesTrainState(post, make_optimizer(PAR_LR, 1e-5).init(post),
                               _clone_tree(src.batch_stats))

    def train(step, state, inputs=tin, labels=tlab, m=tmask):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, met = step(state, inputs, labels, m,
                          torch.Generator().manual_seed(args.seed + 19),
                          PAR_KL_WEIGHT, float(len(labels)))
        torch.cuda.synchronize()
        return (state, met, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2**30,
                (torch.cuda.max_memory_allocated() - mem0) / 2**30)

    state, met, wall, peak, above = counted(
        "per-draw remat", {"stacked_sampler": NUM_MC // VAR_CHUNK,
                           "eps": NUM_MC // VAR_CHUNK},
        lambda: train(make_train_step(bundle.module, meta, spec, NUM_MC,
                                      mc_chunk=VAR_CHUNK,
                                      packed_inputs=True), fresh()))
    if met["skipped"]:
        raise AssertionError("per-draw remat step skipped (non-finite)")
    log(f"per-draw remat: b{TRAIN_BATCH} x {NUM_MC} MC in chunks of "
        f"{VAR_CHUNK}, f32 posterior: {wall:.3f} s, "
        f"{NUM_MC // VAR_CHUNK} stacked + {NUM_MC // VAR_CHUNK} eps launches, "
        f"peak {peak:.2f} GiB ({above:.2f} GiB above the start; phase 7 "
        f"prints chunk 1's) [{smi}]", summary=True)

    # its gradients against remat off where remat off fits at full width,
    # and a control: remat off on the batch's rows swapped
    torch.backends.cudnn.deterministic = True
    try:
        f32mod = multimodal_module(NUM_CLASSES,
                                   ArchConfig(dtype=torch.float32))
        x2, y2, m2 = [a[:VAR_GRAD_BATCH] for a in tin], tlab[
            :VAR_GRAD_BATCH], tmask[:VAR_GRAD_BATCH]
        swap = torch.arange(VAR_GRAD_BATCH, device="cuda").flip(0)
        one = {"stacked_sampler": 1, "eps": 1}

        def grad_step(remat, perm=None):
            step = make_train_step(f32mod, meta, spec, VAR_GRAD_MC,
                                   mc_chunk=VAR_GRAD_MC, packed_inputs=True,
                                   remat=remat)
            xs, ys = x2, y2
            if perm is not None:
                xs, ys = [a[perm] for a in x2], y2[perm]
            return counted(f"per-draw gradients ({remat})", one,
                           lambda: train(step, fresh(), xs, ys, m2),
                           path=False)[:2]

        ref, on, ctl = (grad_step("off"), grad_step("on"),
                        grad_step("off", swap))
        rel = lambda a, r: max(_rel(getattr(a[0].post, k).grad,
                                    getattr(r[0].post, k).grad)
                               for k in ("mu", "rho"))
        loss_rel = abs(float(on[1]["loss"]) - float(ref[1]["loss"])) / abs(
            float(ref[1]["loss"]))
        err, ctl_err = rel(on, ref), rel(ctl, ref)
        gate = max(PAR_GRAD_CONTROL * ctl_err, PAR_GRAD_REPEAT)
        log(f"per-draw remat gradients (b{VAR_GRAD_BATCH} x {VAR_GRAD_MC} in "
            f"one chunk, f32 activations, cuDNN deterministic) against remat "
            f"off: relative L2 {err:.3e} (gate {gate:.3e}: "
            f"{PAR_GRAD_CONTROL:g} x the rows-swapped control {ctl_err:.3e}, "
            f"at least {PAR_GRAD_REPEAT:g}), loss {loss_rel:.2e}, bit-equal "
            f"{torch.equal(on[0].post.mu.grad, ref[0].post.mu.grad)}",
            summary=True)
        if not (err <= gate and loss_rel <= PAR_LOSS_RTOL):
            raise AssertionError("per-draw remat off remat off's gradients")
        del ref, on, ctl, f32mod
        free_cuda()

        # (d) remat="auto": the unimodal b8 x 5 step and the multimodal
        # b12 x 20 step against the explicitly chosen remat
        uni = make_unimodal_bundle(1, NUM_CLASSES, spec,
                                   torch.Generator().manual_seed(args.seed),
                                   ArchConfig(), device="cuda")
        ux = [torch.from_numpy(rng.standard_normal(
            (UNI_TRAIN_BATCH, IMAGE, IMAGE, 1)).astype(np.float32)).cuda()]
        uy = torch.from_numpy(rng.integers(0, NUM_CLASSES,
                                           UNI_TRAIN_BATCH)).cuda()
        um = torch.ones(UNI_TRAIN_BATCH, device="cuda")
        points = (("unimodal sss", uni, UNI_TRAIN_MC, ux, uy, um, False),
                  ("multimodal", bundle, NUM_MC, tin, tlab, tmask, True))
        for label, b, num_mc, xs, ys, ms_, packed_in in points:
            auto = make_train_step(b.module, b.meta, spec, num_mc,
                                   packed_inputs=packed_in, remat="auto")

            def want(out, num_mc=num_mc, auto=auto):
                # the trials sample 1 and 2 draws; remat on re-samples
                fwd = num_mc * (2 if auto.remat_used else 1)
                return {"stacked_sampler": 3 + fwd, "eps": num_mc}

            got = counted(f"remat auto ({label})", want,
                          lambda: train(auto, fresh(b), xs, ys, ms_))
            chosen = "on" if auto.remat_used else "off"
            exp = counted(f"remat {chosen} ({label})",
                          {"stacked_sampler": num_mc * (
                              2 if auto.remat_used else 1), "eps": num_mc},
                          lambda: train(make_train_step(
                              b.module, b.meta, spec, num_mc,
                              packed_inputs=packed_in, remat=chosen),
                              fresh(b), xs, ys, ms_), path=False)
            loss_rel = abs(float(got[1]["loss"]) - float(exp[1]["loss"])) / \
                abs(float(exp[1]["loss"]))
            post_rel = max(_rel(getattr(got[0].post, k).detach(),
                                getattr(exp[0].post, k).detach())
                           for k in ("mu", "rho"))
            need = auto.need_bytes
            log(f"remat auto, {label} b{len(ys)} x {num_mc}: needs "
                f"{'n/a' if need is None else f'{need / 2**30:.2f} GiB'} "
                f"without remat, budget {auto.budget_bytes / 2**30:.2f} GiB "
                f"-> remat {chosen}; {got[2]:.3f} s (trials included) "
                f"against {exp[2]:.3f} s explicit; loss {loss_rel:.2e}, "
                f"updated posterior relative L2 {post_rel:.2e}, bit-equal "
                f"{torch.equal(got[0].post.mu, exp[0].post.mu)}; peak "
                f"{got[3]:.2f} GiB [{smi}]", summary=True)
            if not (loss_rel <= PAR_LOSS_RTOL and post_rel <= PAR_GRAD_REPEAT
                    and need is not None):
                raise AssertionError(f"remat auto ({label}) off the "
                                     f"explicit remat {chosen}")
            del got, exp, auto
            free_cuda()
        del uni
    finally:
        torch.backends.cudnn.deterministic = False

    # (e) async checkpoints of the full-width train state
    a_path, s_path = (os.path.join(work, f"{k}.pt") for k in ("async",
                                                             "sync"))
    mu_before = state.post.mu.detach().to("cpu", copy=True)
    t0 = time.perf_counter()
    ckpt.save_train_state(a_path, state, 1, {"multimodal": 1},
                          async_save=True)
    t_async = time.perf_counter() - t0
    with torch.no_grad():
        state.post.mu.add_(1.0)  # changed after the call: not in the file
    t0 = time.perf_counter()
    ckpt.wait_for_saves()
    t_wait = time.perf_counter() - t0
    with torch.no_grad():
        state.post.mu.copy_(mu_before)
    t0 = time.perf_counter()
    ckpt.save_train_state(s_path, state, 1, {"multimodal": 1})
    t_sync = time.perf_counter() - t0
    fa, fs = (dict(_walk(torch.load(p, weights_only=True)))
              for p in (a_path, s_path))
    same = fa.keys() == fs.keys() and all(
        torch.equal(v, fs[k]) if isinstance(v, torch.Tensor) else v == fs[k]
        for k, v in fa.items())
    if not (same and torch.equal(fa[("state", "post", "mu")], mu_before)):
        raise AssertionError("async checkpoint != sync checkpoint, or the "
                             "change after the call reached it")
    log(f"async checkpoints: the full-width train state "
        f"({os.path.getsize(a_path) / 1e9:.3f} GB): async call "
        f"{t_async:.3f} s, wait_for_saves {t_wait:.3f} s, sync call "
        f"{t_sync:.3f} s; files equal, the change after the async call not "
        f"in its file [{smi}]", summary=True)
    del state, fa, fs, mu_before
    free_cuda()

    # (f) non-MOPED init at full width
    t0 = time.perf_counter()
    nb = make_multimodal_bundle(NUM_CLASSES, BNNPriorSpec(moped_enable=False),
                                torch.Generator().manual_seed(args.seed + 19),
                                ArchConfig(), device="cuda")
    t_build = time.perf_counter() - t0
    n = nb.meta.n_real
    moments = {}
    for name, x, init in (("mu", nb.post.mu, spec.posterior_mu_init),
                          ("rho", nb.post.rho, spec.posterior_rho_init)):
        x = x[:n].double()
        moments[name] = (float(x.mean()), float(x.std()))
        if not (abs(moments[name][0] - init) < 4 * 0.1 / math.sqrt(n)
                and abs(moments[name][1] / 0.1 - 1.0) < 0.01):
            raise AssertionError(f"non-MOPED {name} moments {moments[name]}")
    out = counted("non-MOPED predict", {"split_sampler": NUM_MC // 2},
                  lambda: make_packed_predict_step(nb, NUM_MC)(
                      nb.post, nb.batch_stats, u8,
                      torch.Generator().manual_seed(args.seed), mask))
    if not (torch.isfinite(out["csv_cols"]).all()
            and torch.isfinite(out["mean_prob"]).all()):
        raise AssertionError("non-MOPED predict: non-finite outputs")
    log(f"non-MOPED: full-width bundle in {t_build:.1f} s, mu mean / std "
        f"{moments['mu'][0]:.3e} / {moments['mu'][1]:.6f}, rho "
        f"{moments['rho'][0]:.6f} / {moments['rho'][1]:.6f} over {n} "
        f"elements; one b{BATCH} x {NUM_MC} batch finite, classes "
        f"{out['predicted'][mask].tolist()}", summary=True)
    del nb, out
    log(f"phase 19 (MC variants, training): {time.perf_counter() - t_phase:.1f}"
        f" s; launches on its paths {on_path}", summary=True)
    return on_path


# the files of one data-prep sample folder (tests/test_etl_pipeline.py:81-90)
PREP_FILES = ("row_data.csv", "unlabelled.txt", "output_channel_1.png",
              "output_channel_2.png", "grid_a_b_SSS.png",
              "combined_channels.png")


def write_raw_survey(root: str, seed: int) -> tuple:
    """A raw GAVIA dive of PREP_FRAMES random 512 x 384 JPEGs whose
    telemetry sits in the JPEG comment (as tests/test_etl_pipeline.py
    writes it), a few metres apart near 55.5 N 5.5 W, and a bathymetry
    (2 bands, LZW, predictor 2) and an SSS (deflate) GeoTIFF of 200 x 200
    px at 0.5 m covering them, written by the port's ``write_geotiff``.
    Returns (raw folder, GeoTIFF folder)."""
    from PIL import Image

    from multimodal_auv_torch.dataprep.geodesy import latlon_to_utm
    from multimodal_auv_torch.dataprep.geotiff import write_geotiff

    rng = np.random.default_rng(seed + 200)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "dive1"))
    for i in range(PREP_FRAMES):
        com = (f"<telemetry><lat>5530.{i * 2:03d}N</lat>"
               f"<lon>00530.{i:03d}W</lon><altitude>2.5</altitude>"
               f"<depth>{30 + i}.0</depth><heading>180.0</heading>"
               f"<pitch>1.0</pitch><roll>0.5</roll><surge>0.1</surge>"
               f"<sway>0.2</sway></telemetry>")
        Image.fromarray(rng.integers(30, 120, (384, 512, 3), dtype=np.uint8)
                        ).save(os.path.join(raw, "dive1",
                                            f"frame_{i:04d}.jpg"),
                               comment=com.encode())
    e, n, _, _ = latlon_to_utm(55.5, -5.5)
    tr = (e - 50.0, 0.5, 0.0, n + 50.0, 0.0, -0.5)
    tiffs = os.path.join(root, "tiffs")
    os.makedirs(tiffs)
    write_geotiff(os.path.join(tiffs, "site_a_b_Bathy.tif"),
                  rng.integers(0, 256, (200, 200, 2)).astype(np.uint8), tr,
                  compression="lzw", predictor=2, rows_per_strip=32)
    write_geotiff(os.path.join(tiffs, "site_a_b_SSS.tif"),
                  rng.integers(0, 256, (200, 200)).astype(np.uint8), tr,
                  compression="deflate", rows_per_strip=64)
    return raw, tiffs


def check_native(raw: str, tiffs: str, smi: str) -> None:
    """Phase 20 (f): the port's C++ host runtime (``native/``), built on
    this machine at first use; it must build. On the phase's data-prep
    frames, ``load_image_u8`` to IMAGE px through the native decode and
    resize against its fallback where the runtime has no decoder (PIL's
    decode and convert, then the native resize), RGB and L, byte for byte;
    the PIL-only path (no runtime) beside, whose resize differs. On the
    LZW bathymetry GeoTIFF's strips, the native decoder against the Python
    fallback, byte for byte. Prints ms per image of each path and the LZW
    decoders' MB/s (decoded bytes)."""
    from multimodal_auv_torch import native
    from multimodal_auv_torch.data import transforms as T
    from multimodal_auv_torch.dataprep import geotiff as G

    lib = native.lib
    log(f"native host runtime: lib is not None: {lib is not None}, "
        f"has_decode: {getattr(lib, 'has_decode', None)}")
    if lib is None:
        raise AssertionError("the native host runtime did not build")

    class NoDecode:
        has_decode = False

        def __getattr__(self, k):
            return getattr(lib, k)

    frames = sorted(os.path.join(raw, "dive1", f)
                    for f in os.listdir(os.path.join(raw, "dive1")))
    paths = (("native decode + resize", lib),
             ("PIL decode + native resize", NoDecode()),
             ("PIL decode + PIL resize", None))
    outs, ms, real = {}, {}, T._native_lib
    try:
        for name, runtime in paths:
            T._native_lib = lambda runtime=runtime: runtime
            T.load_image_u8(frames[0], "RGB", (IMAGE, IMAGE))  # warm-up
            t0 = time.perf_counter()
            for _ in range(NATIVE_REPEATS):
                got = [T.load_image_u8(f, "RGB", (IMAGE, IMAGE))
                       for f in frames]
            ms[name] = ((time.perf_counter() - t0) * 1e3
                        / (NATIVE_REPEATS * len(frames)))
            outs[name] = got + [T.load_image_u8(f, "L", (IMAGE, IMAGE))
                                for f in frames]
    finally:
        T._native_lib = real
    a, b, c = (outs[name] for name, _ in paths)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("native decode + resize != PIL decode + "
                             "native resize")
    pil_d = max(int(np.abs(x.astype(int) - y.astype(int)).max())
                for x, y in zip(a, c))

    strips, lzw = [], G._native_or_py_lzw
    G._native_or_py_lzw = lambda data, n: (strips.append((data, n)),
                                           lzw(data, n))[1]
    try:
        tif = G.GeoTiff.open(os.path.join(tiffs, "site_a_b_Bathy.tif"))
        tif.read(0)
    finally:
        G._native_or_py_lzw = lzw
    rates = {}
    for name, decode in (("native", lib.lzw_decode),
                         ("Python", G._lzw_decode)):
        t0 = time.perf_counter()
        for _ in range(NATIVE_REPEATS):
            got = [decode(data, n) for data, n in strips]
        rates[name] = (NATIVE_REPEATS * sum(n for _, n in strips)
                       / (time.perf_counter() - t0) / 1e6)
        if name == "native":
            want = got
    if got != want or not strips:
        raise AssertionError(f"LZW: native != Python on {len(strips)} "
                             f"strips")
    log(f"phase 20 native host runtime: {len(frames)} frames (512 x 384 "
        f"JPEG) to {IMAGE} px, ms per image: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in ms.items())}; native == "
        f"PIL decode + native resize byte for byte (RGB and L), PIL-only "
        f"max |d| {pil_d}; LZW over {len(strips)} strips "
        f"({sum(n for _, n in strips)} bytes): native "
        f"{rates['native']:.1f} MB/s, Python {rates['Python']:.2f} MB/s, "
        f"byte-equal [{smi}]", summary=True)


def _study_launches(n_train: int, n_eval: int, runs: int) -> dict:
    """Launches of ``runs`` epochs of n_train train steps (chunk 1, remat
    on: each draw sampled in the forward and again in the re-forward,
    its eps regenerated in the backward) and n_eval eval batches."""
    return {"stacked_sampler": runs * n_train * STUDY_MC * 2,
            "eps": runs * n_train * STUDY_MC,
            "split_sampler": runs * n_eval * STUDY_MC}


def phase_studies(args, smi: str, work: str) -> dict:
    """Phase 20 (ROADMAP item 9's studies) at full width: the UIFM noise
    study and its metrics, one evaluation batch under
    ``utils.profiling.trace``, the patch-size sweep and ``data-prep``.
    Returns the phase's launches by kernel name."""
    from multimodal_auv_torch import cli
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.data.loaders import (
        prepare_datasets_and_loaders,
        split_indices,
    )
    from multimodal_auv_torch.dataprep.qa import survey_tree_report
    from multimodal_auv_torch.engine.optim import BayesTrainState
    from multimodal_auv_torch.engine.steps import make_eval_step
    from multimodal_auv_torch.engine.uifm import BETA_RGB, B_INF_RGB
    from multimodal_auv_torch.engine.uifm import sample_turbidity
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.ops import kernels
    from multimodal_auv_torch.pipelines import noise_study as NS
    from multimodal_auv_torch.pipelines import sweep as SW
    from multimodal_auv_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    total = {"split_sampler": 0, "stacked_sampler": 0, "eps": 0}
    root = write_training_tree(os.path.join(work, "study_tree"), args.seed,
                               n_samples=STUDY_SAMPLES)
    train_idx, test_idx = split_indices(STUDY_SAMPLES)
    steps_of = lambda b: (-(-len(train_idx) // b), -(-len(test_idx) // b))

    # (a) the noise study: per centre one degraded fine-tuning epoch from
    # the initial weights, then a degraded evaluation with the extended
    # metrics
    csv_dir = os.path.join(work, "noise_study")
    want = _study_launches(*steps_of(STUDY_BATCH), len(STUDY_CENTERS))
    eval_times = []
    real_eval = NS.evaluate_with_degradation

    def timed_eval(*a, **kw):
        t0 = time.perf_counter()
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        eval_times.append(time.perf_counter() - t0)
        return out

    NS.evaluate_with_degradation = timed_eval
    reset_launches()
    t0 = time.perf_counter()
    try:
        with timed_train_steps(NS) as (times, _):
            results = NS.run_noise_study(
                root, csv_dir, turbidity_centers=STUDY_CENTERS,
                depth_levels=(STUDY_DEPTH,), train_epochs_per_step=1,
                num_mc=STUDY_MC, batch_size=STUDY_BATCH, arch=ArchConfig(),
                seed=args.seed, strict_errors=True)
        torch.cuda.synchronize()
    finally:
        NS.evaluate_with_degradation = real_eval
    wall = time.perf_counter() - t0
    got = check_launches("phase 20 noise study", want)
    for k in total:
        total[k] += got[k]
    csv_path = os.path.join(csv_dir, f"noise_study_depth{STUDY_DEPTH}.csv")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
        header = rows and list(rows[0])
    extra = ["F1_Score", "ECE", "Emax", "Turbidity", "Depth"]
    if (header[:len(NS.EVAL_CSV_HEADER)] != NS.EVAL_CSV_HEADER
            or not set(extra) <= set(header)
            or [r["Turbidity"] for r in rows] != [
                "%.3f" % c for c in STUDY_CENTERS]
            or {r["Depth"] for r in rows} != {str(STUDY_DEPTH)}):
        raise AssertionError(f"noise-study CSV {header}: {rows}")
    vals = [float(rows[-1][k]) for k in ("Test Loss", "Test Accuracy",
                                         "Predictive Uncertainty",
                                         "F1_Score", "ECE", "Emax")]
    if not np.isfinite(vals).all() or len(results) != len(STUDY_CENTERS):
        raise AssertionError(f"noise-study values {rows[-1]} {results}")
    per = sorted(os.listdir(os.path.join(csv_dir, "per_sample_metrics")))
    if len(per) != len(STUDY_CENTERS):
        raise AssertionError(f"per-sample CSVs {per}")
    later = times[1:] or times
    log(f"phase 20 noise study: {len(STUDY_CENTERS)} turbidity centres x 1 "
        f"epoch over {STUDY_SAMPLES} folders ({len(train_idx)} train / "
        f"{len(test_idx)} eval), b{STUDY_BATCH} x {STUDY_MC} MC, full width, "
        f"in {wall:.2f} s [{smi}]: {sum(later) / len(later):.3f} s per train "
        f"step after the first ({len(times)} steps: "
        f"{', '.join(f'{t:.3f}' for t in times)}), "
        f"{sum(eval_times) / len(eval_times):.3f} s per evaluation "
        f"({', '.join(f'{t:.3f}' for t in eval_times)}); launches {got}, "
        f"want {want}; CSV columns {header}; last row AUROC "
        f"{rows[-1].get('uncertainty_error_auroc')} F1 {rows[-1]['F1_Score']}"
        f" ECE {rows[-1]['ECE']} Emax {rows[-1]['Emax']}", summary=True)

    # (b) one batch degraded on the card against the CPU, the turbidity
    # drawn from the same seed on both
    loader = prepare_datasets_and_loaders(
        root, batch_size_multimodal=STUDY_BATCH, image_size=IMAGE)[3]
    batch = next(iter(loader))
    trange, seed = (1.0, 1.1), args.seed + 20
    build = lambda dev: NS._build_inputs(
        batch, torch.Generator().manual_seed(seed), trange, STUDY_DEPTH,
        "multimodal", None, None, STUDY_BATCH, torch.device(dev))
    card, cpu = build("cuda")[0][0].cpu(), build("cpu")[0][0]
    if card.dtype != torch.float32 or cpu.dtype != torch.float32:
        raise AssertionError(f"UIFM dtypes {card.dtype}, {cpu.dtype}")
    card, cpu = card.double(), cpu.double()
    turb = sample_turbidity(torch.Generator().manual_seed(seed), trange)
    t = np.exp(-np.asarray(BETA_RGB) * turb * STUDY_DEPTH)
    clean = np.asarray(batch["main_image"], np.float64)
    clean = np.concatenate([clean, np.repeat(clean[-1:], STUDY_BATCH
                                             - len(clean), 0)])
    scale = np.abs(clean) * t + np.asarray(B_INF_RGB) * (1 - t)
    err = (card - cpu).abs().numpy()
    rel = float((err / scale).max())
    if rel > UIFM_RTOL:
        raise AssertionError(f"UIFM card vs CPU: {rel:.3e} of the terms")
    log(f"UIFM degradation of one b{STUDY_BATCH} batch at turbidity "
        f"{turb:.4f}: card vs CPU max |d| {float(err.max()):.3e}, "
        f"{rel:.3e} of the terms (gate {UIFM_RTOL}), bit-equal "
        f"{bool((err == 0).all())}")

    # (c) one evaluation batch of the study under utils.profiling.trace:
    # the Chrome trace holds a sampler_kernel event per launch counted
    spec = BNNPriorSpec()
    bundle = make_multimodal_bundle(
        NUM_CLASSES, spec, torch.Generator().manual_seed(args.seed),
        ArchConfig(), device="cuda")
    estep = make_eval_step(bundle.module, bundle.meta, spec, STUDY_MC)
    state = BayesTrainState(bundle.post, None, bundle.batch_stats)
    if len(loader) != 1:
        raise AssertionError(f"{len(loader)} eval batches, want 1")
    ev = lambda name: real_eval(
        estep, state, loader, 0, 1, os.path.join(work, name), "multimodal",
        torch.Generator().manual_seed(seed), trange, STUDY_DEPTH,
        strict_errors=True)
    ev("warm.csv")  # cuDNN's algorithm choice outside the trace
    torch.cuda.synchronize()
    trace_dir = os.path.join(work, "trace")
    reset_launches()
    t0 = time.perf_counter()
    with trace(trace_dir, device="cuda") as d:
        ev("traced.csv")
    t_trace = time.perf_counter() - t0
    inside = check_launches("phase 20 traced evaluation",
                            {"split_sampler": STUDY_MC})
    total["split_sampler"] += inside["split_sampler"]
    (path,) = [os.path.join(d, f) for f in os.listdir(d)
               if f.endswith(".pt.trace.json")]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    samp = [e for e in kern if "sampler_kernel" in e.get("name", "")]
    if len(samp) != sum(inside.values()):
        raise AssertionError(f"trace: {len(samp)} sampler_kernel events, "
                             f"{inside} launches counted")
    log(f"phase 20 trace: one evaluation batch (b{STUDY_BATCH} x "
        f"{STUDY_MC} MC) under utils.profiling.trace in {t_trace:.2f} s: "
        f"{len(kern)} kernel events, {len(samp)} sampler_kernel == "
        f"{sum(inside.values())} launches counted; trace "
        f"{os.path.getsize(path) / 2**20:.1f} MiB", summary=True)
    del bundle, state, estep, events, kern, samp
    free_cuda()

    # (d) the patch-size sweep: each combo one epoch from the same weights
    sweep_dir = os.path.join(work, "sweep")
    combos = len(SWEEP_BATHY) * len(SWEEP_SSS)
    want = _study_launches(*steps_of(SWEEP_BATCH), combos)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(work):
        res = SW.run_patch_size_sweep(
            root, sweep_dir, bathy_sizes=SWEEP_BATHY, sss_sizes=SWEEP_SSS,
            num_epochs=1, num_mc=STUDY_MC, batch_size=SWEEP_BATCH,
            arch=ArchConfig(), seed=args.seed)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = check_launches("phase 20 sweep", want)
    for k in total:
        total[k] += got[k]
    with open(os.path.join(sweep_dir, "patch_sweep_summary.csv"),
              newline="") as f:
        summary = list(csv.reader(f))
    pairs = [[str(b), str(s)] for b in SWEEP_BATHY for s in SWEEP_SSS]
    if (summary[0] != ["bathy_patch_m", "sss_patch_m", "final_eval_accuracy"]
            or [r[:2] for r in summary[1:]] != pairs
            or not all(0 <= float(r[2]) <= 1 for r in summary[1:])):
        raise AssertionError(f"sweep summary {summary}")
    for b, s_ in pairs:
        if not os.path.exists(os.path.join(
                sweep_dir, f"b{b}_s{s_}", "multimodal_eval_results.csv")):
            raise AssertionError(f"sweep combo b{b}_s{s_}: no eval CSV")
    log(f"phase 20 sweep: {combos} combos (bathy {SWEEP_BATHY} m x SSS "
        f"{SWEEP_SSS} m) x 1 epoch, b{SWEEP_BATCH} x {STUDY_MC} MC, full "
        f"width, in {wall:.2f} s = {wall / combos:.2f} s per combo [{smi}]; "
        f"summary {summary[1:]}; launches {got}, want {want}", summary=True)

    # (e) data-prep through the CLI: raw JPEGs + GeoTIFFs -> sample folders
    raw, tiffs = write_raw_survey(os.path.join(work, "prep"), args.seed)
    out = os.path.join(work, "prep", "out")
    t0 = time.perf_counter()
    rc = cli.main(["data-prep", "--raw_optical_images_folder", raw,
                   "--geotiff_folder", tiffs, "--output_folder", out])
    wall = time.perf_counter() - t0
    samples = os.path.join(out, "samples")
    names = [f"frame_{i:04d}" for i in range(PREP_FRAMES)]
    if rc != 0 or sorted(os.listdir(samples)) != names:
        raise AssertionError(f"data-prep rc {rc}: {os.listdir(out)}")
    for name in names:
        missing = set((f"{name}.jpg",) + PREP_FILES) - set(
            os.listdir(os.path.join(samples, name)))
        if missing:
            raise AssertionError(f"data-prep {name}: missing {missing}")
    # the JAX package's data-prep output gets the same verdict: its
    # combined bathy is combined_channels.png, a name the inference scan
    # does not take, so "missing-bathy" is every folder's only problem
    rep = survey_tree_report(samples, kind="inference")
    if rep.problem_histogram() != {"missing-bathy": PREP_FRAMES}:
        raise AssertionError("data-prep QA: " + "; ".join(
            rep.summary_lines()))
    log(f"phase 20 data-prep: {PREP_FRAMES} frames (512 x 384) + LZW "
        f"bathymetry and deflate SSS GeoTIFFs -> {PREP_FRAMES} sample "
        f"folders in {wall:.2f} s = {wall / PREP_FRAMES:.3f} s per frame "
        f"(host); QA: main and SSS found in every folder, "
        f"{rep.problem_histogram()}", summary=True)

    # (f) the C++ host runtime on this machine, against its fallbacks
    check_native(raw, tiffs, smi)
    log(f"phase 20 (studies): {time.perf_counter() - t_phase:.1f} s; "
        f"launches {total}", summary=True)
    return total


def learning_gates(pred, prob, unc, labels, is_ambig) -> dict:
    """tests/test_learning.py:64's four gates on a probe set's outputs:
    clean accuracy >= 0.9; mean predictive uncertainty on the ambiguous
    samples > 1.2x the clean ones'; a finite clean-set ECE < 0.30;
    AUROC(uncertainty -> error) > 0.5 where the set has hits and errors.
    Returns what they measured."""
    from multimodal_auv_torch.engine.metrics import (
        calibration_metrics,
        uncertainty_error_auroc,
    )

    clean_acc = float((pred[~is_ambig] == labels[~is_ambig]).mean())
    if clean_acc < 0.9:
        raise AssertionError(f"learning: clean held-out accuracy {clean_acc}")
    u_ambig = float(unc[is_ambig].mean())
    u_clean = float(unc[~is_ambig].mean())
    if not u_ambig > 1.2 * u_clean:
        raise AssertionError(f"learning: uncertainty ambiguous {u_ambig} "
                             f"not > 1.2 x clean {u_clean}")
    ece, emax = calibration_metrics(prob[~is_ambig], labels[~is_ambig])
    if not (np.isfinite(ece) and np.isfinite(emax) and ece < 0.30):
        raise AssertionError(f"learning: clean-set ECE {ece}, Emax {emax}")
    auroc = None
    if (pred != labels).any() and (pred == labels).any():
        auroc = float(uncertainty_error_auroc(pred, labels, unc))
        if not auroc > 0.5:
            raise AssertionError(f"learning: uncertainty-error AUROC {auroc}")
    return {"clean_acc": clean_acc, "unc_ambig": u_ambig,
            "unc_clean": u_clean, "ece": float(ece), "auroc": auroc}


def phase_learning(args, smi: str, work: str) -> dict:
    """Phase 21 ("learning"): tests/test_learning.py:64's recipe on the
    card. ``run_AUV_training_from_scratch(device=None)`` on a separable
    synthetic tree (tests/fixtures/make_tree.py) at micro(), 32 px, then
    the end-of-training state restored through ``restore_train_state``
    and an unseen probe tree predicted (``make_predict_step``, f32
    weights). The four gates of ``learning_gates``; exact launches of #2
    and #3 in training (remat on, chunk 1: 2 stacked and 1 eps per draw of
    each step) and of #1 in its evaluations and the prediction (one split
    launch per draw of an eval batch, one per chunk of 2 draws). cuDNN
    runs its deterministic algorithms throughout: with its default ones
    the same run's uncertainty-error AUROC varied from 0.4 to 1.0 between
    runs on an H100 (the gate is > 0.5), so the phase's outcome was not a
    function of the code. Returns the phase's launches."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        return _learning(args, smi, work)


def _learning(args, smi: str, work: str) -> dict:
    from tests.fixtures.make_tree import make_separable_training_tree

    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.data.datasets import MultimodalFolderDataset
    from multimodal_auv_torch.data.loaders import DataLoader, split_indices
    from multimodal_auv_torch.engine.checkpointing import restore_train_state
    from multimodal_auv_torch.engine.loops import select_patch
    from multimodal_auv_torch.engine.optim import (
        BayesTrainState,
        make_optimizer,
    )
    from multimodal_auv_torch.engine.predict import make_predict_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        make_multimodal_bundle,
    )
    from multimodal_auv_torch.pipelines import training as pipeline

    t_phase = time.perf_counter()
    spec = BNNPriorSpec(moped_enable=False)
    arch = ArchConfig.micro(image_size=32)
    root = make_separable_training_tree(
        os.path.join(work, "learn_train"), n_per_class=LEARN_PER_CLASS,
        seed=args.seed)
    state_path = os.path.join(work, "learn_state.pt")
    reset_launches()
    t0 = time.perf_counter()
    with timed_train_steps(pipeline) as (times, _), contextlib.chdir(work):
        ok = pipeline.run_AUV_training_from_scratch(
            spec.to_dict(), LEARN_LR, LEARN_EPOCHS, LEARN_MC, 10, 10,
            LEARN_BATCH, root, num_classes=0, arch=arch, seed=args.seed,
            strict_errors=True, handle_preemption=False,
            resume_checkpoint=state_path)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"learning: run_AUV_training_from_scratch "
                             f"returned {ok}")
    train_idx, test_idx = split_indices(LEARN_CLASSES * LEARN_PER_CLASS)
    n_steps = -(-len(train_idx) // LEARN_BATCH)
    n_evals = -(-len(test_idx) // LEARN_BATCH)
    trained = check_launches("learning: training", {
        "stacked_sampler": LEARN_EPOCHS * n_steps * LEARN_MC * 2,
        "eps": LEARN_EPOCHS * n_steps * LEARN_MC,
        "split_sampler": LEARN_EPOCHS * n_evals * LEARN_MC})

    bundle = make_multimodal_bundle(
        LEARN_CLASSES, spec, torch.Generator().manual_seed(args.seed), arch,
        device="cuda")
    template = BayesTrainState(
        post=bundle.post,
        opt_state=make_optimizer(LEARN_LR, 1e-5).init(bundle.post),
        batch_stats=bundle.batch_stats)
    state, epoch, _ = restore_train_state(state_path, template)
    if epoch != LEARN_EPOCHS:
        raise AssertionError(f"learning: restored epoch {epoch}")
    bundle.post, bundle.batch_stats = state.post, state.batch_stats

    probe = make_separable_training_tree(
        os.path.join(work, "learn_probe"), n_per_class=LEARN_PROBE_PER_CLASS,
        ambiguous_per_class=LEARN_PROBE_PER_CLASS, seed=args.seed + 1)
    ds = MultimodalFolderDataset(probe, image_size=32)
    batch = next(iter(DataLoader(ds, batch_size=len(ds), shuffle=False)))
    names = [os.path.basename(os.path.dirname(p["main_image"]))
             for p in ds.data_paths]
    is_ambig = np.asarray([n.startswith("ambig") for n in names])
    inputs = tuple(torch.from_numpy(np.asarray(a, np.float32)).cuda()
                   for a in (batch["main_image"],
                             select_patch(batch, "patch_10_bathy", "bathy"),
                             select_patch(batch, "patch_10_sss", "sss")))
    labels = np.asarray(batch["label"], np.int64)
    step = make_predict_step(bundle, LEARN_PROBE_MC, sample_dtype=None)
    reset_launches()
    out = step(bundle.post, bundle.batch_stats, inputs,
               torch.Generator().manual_seed(args.seed + 3))
    torch.cuda.synchronize()
    probed = check_launches("learning: probe",
                            {"split_sampler": LEARN_PROBE_MC // 2})
    report = learning_gates(out["predicted"].cpu().numpy(),
                            out["mean_prob"].float().cpu().numpy(),
                            out["predictive_uncertainty"].float().cpu()
                            .numpy(), labels, is_ambig)
    del bundle, template, state, out
    later = times[1:]
    log(f"phase 21 (learning): run_AUV_training_from_scratch at micro(), "
        f"32 px, {LEARN_EPOCHS} epochs of {n_steps} steps of {LEARN_BATCH} "
        f"x {LEARN_MC} MC and {n_evals} eval batch(es) in {wall:.2f} s = "
        f"{wall / LEARN_EPOCHS:.3f} s per epoch (scan, decode, evals and "
        f"checkpoints included), {sum(later) / len(later):.4f} s per train "
        f"step after the first [{smi}]; unseen probe of {len(ds)} "
        f"({int(is_ambig.sum())} ambiguous) at {LEARN_PROBE_MC} MC: clean "
        f"held-out accuracy {report['clean_acc']:.4f}, predictive "
        f"uncertainty ambiguous {report['unc_ambig']:.6g} vs clean "
        f"{report['unc_clean']:.6g}, ECE {report['ece']:.4f}, AUROC "
        f"{report['auroc']}; launches training {trained}, probe {probed}; "
        f"phase {time.perf_counter() - t_phase:.1f} s", summary=True)
    return {k: trained[k] + probed[k] for k in trained}


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    # one rank of phase 18 (the script starts them itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--work", default="", help=argparse.SUPPRESS)
    ap.add_argument("--job", default="parallel", help=argparse.SUPPRESS)
    ap.add_argument("--weights", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return (serving_rank(args) if args.job.startswith("serving")
                else parallel_rank(args))

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
        bundle, split_entry, mc_rate = phase_main_path(args, smi, work)
        kernels_line = [split_entry] + phase_training(args, smi, bundle,
                                                      work)
        free_cuda()
        split_entry["launches"] += phase_fused(args, smi, bundle, work)
        free_cuda()
        parallel = phase_parallel(args, smi, bundle, work)
        for e in kernels_line:
            e["launches"] += parallel.get(e["name"], 0)
        free_cuda()
        variants = phase_variants(args, smi, bundle, work)
        for e in kernels_line:
            e["launches"] += variants[e["name"]]
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
        serving = phase_serving(args, smi, work, weights)
        split_launches += serving["split_sampler"]
        free_cuda()
        split_launches += phase_dvp(args, smi, work, weights, mc_rate)
        free_cuda()
        studies = phase_studies(args, smi, work)
        free_cuda()
        learning = phase_learning(args, smi, work)
        free_cuda()
        # each kernel's launches on the paths: add phases 13, 14, 15, 16,
        # 20 and 21 (17 and 18 were added above)
        retrain["split_sampler"] += split_launches
        retrain["stacked_sampler"] += serving["stacked_sampler"]
        for e in kernels_line:
            e["launches"] += (retrain[e["name"]] + studies.get(e["name"], 0)
                              + learning.get(e["name"], 0))
        # #2's bf16 kernel at the mc shard: the mc-sharded run's launches
        # (every stacked launch there writes bf16)
        kernels_line.append(serving["bf16_entry"])
        kernels_line += phase_probe(smi, P_full)
    log("summary of phases 15, 16 (f) and 17-21:\n  " + "\n  ".join(SUMMARY))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
