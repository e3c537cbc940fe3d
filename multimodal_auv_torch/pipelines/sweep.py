"""Sonar patch-size optimisation sweep (port of
``multimodal_auv_tpu/pipelines/sweep.py``): the reference main.py's
research grid search (main.py:94-184, grid {2,5,10,30,50}m bathy x
{2,5,10,30,50}m SSS; 30 m documented optimal, README.md:248), runnable
rather than commented out.

Each combo trains + evaluates the multimodal BNN with that patch pairing,
from the same initial weights; results land in one summary CSV. One train
step and one eval step serve every combo (only the selected patch arrays
change).
"""
from __future__ import annotations

import csv
import itertools
import logging
import os
from typing import Optional, Sequence

import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.loaders import prepare_datasets_and_loaders
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine.loops import train_and_evaluate_multimodal_model
from multimodal_auv_torch.engine.optim import (
    StepLR,
    fresh_train_state,
    make_optimizer,
)
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.models.model_utils import ArchConfig, make_multimodal_bundle
from multimodal_auv_torch.utils.tb import SummaryWriter

logger = logging.getLogger(__name__)

DEFAULT_GRID = (2, 5, 10, 30, 50)


def run_patch_size_sweep(
    root_dir: str,
    csv_dir: str,
    *,
    bathy_sizes: Sequence[int] = DEFAULT_GRID,
    sss_sizes: Sequence[int] = DEFAULT_GRID,
    num_epochs: int = 5,
    num_mc: int = 5,
    batch_size: int = 8,
    lr: float = 1e-5,
    weight_decay: float = 1e-5,
    num_classes: int = 0,
    arch: Optional[ArchConfig] = None,
    mc_chunk: int = 1,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Train and evaluate each (bathy, SSS) patch size pairing for
    ``num_epochs`` through the multimodal epoch loops (StepLR(lr, 7,
    0.752), ledgers and TensorBoard under ``<csv_dir>/b<B>_s<S>``), and
    append each combo's final eval accuracy to
    ``<csv_dir>/patch_sweep_summary.csv``. ``device``: None is the card
    (raises without one); ``"cpu"`` runs the kernels' plain versions."""
    dev = resolve_device(device)
    arch = arch or ArchConfig()
    spec = BNNPriorSpec()
    (_, _, train_loader, test_loader, actual_classes, dataset) = (
        prepare_datasets_and_loaders(root_dir,
                                     batch_size_multimodal=batch_size,
                                     image_size=arch.image_size))
    if num_classes in (None, 0):
        num_classes = actual_classes

    os.makedirs(csv_dir, exist_ok=True)
    summary_path = os.path.join(csv_dir, "patch_sweep_summary.csv")
    fresh = not os.path.exists(summary_path)
    bundle = make_multimodal_bundle(num_classes, spec,
                                    torch.Generator().manual_seed(seed), arch,
                                    device=dev)
    tx = make_optimizer(lr, weight_decay)
    tstep = make_train_step(bundle.module, bundle.meta, spec, num_mc,
                            mc_chunk=mc_chunk)
    estep = make_eval_step(bundle.module, bundle.meta, spec, num_mc,
                           mc_chunk=mc_chunk)

    results = []
    with open(summary_path, "a", newline="") as f:
        w = csv.writer(f)
        if fresh:
            w.writerow(["bathy_patch_m", "sss_patch_m", "final_eval_accuracy"])
        for bsize, ssize in itertools.product(bathy_sizes, sss_sizes):
            bathy_pt = f"patch_{bsize}m_bathy"
            sss_pt = f"patch_{ssize}m_sss"
            logger.info("Sweep combo bathy=%sm sss=%sm", bsize, ssize)

            state = fresh_train_state(bundle.post, bundle.batch_stats, tx)
            combo_dir = os.path.join(csv_dir, f"b{bsize}_s{ssize}")
            sw = SummaryWriter(os.path.join(combo_dir, "tb"))
            try:
                train_and_evaluate_multimodal_model(
                    train_loader, test_loader, num_epochs, tstep, estep,
                    state, StepLR(lr, 7, 0.752), combo_dir, sw,
                    seed + bsize * 100 + ssize,
                    bathy_patch_type=bathy_pt, sss_patch_type=sss_pt,
                    class_names=[str(c) for c in
                                 dataset.label_encoder.classes_])
            finally:
                sw.close()
            # final accuracy from the last eval CSV row
            eval_csv = os.path.join(combo_dir, "multimodal_eval_results.csv")
            acc = ""
            if os.path.exists(eval_csv):
                with open(eval_csv, newline="") as ef:
                    rows = list(csv.reader(ef))
                if len(rows) > 1:
                    acc = rows[-1][3]
            w.writerow([bsize, ssize, acc])
            f.flush()
            results.append({"bathy": bsize, "sss": ssize, "accuracy": acc})
    return results
