"""UIFM robustness study — the noise-sweep drivers (port of
``multimodal_auv_tpu/pipelines/noise_study.py``).

The reference's "Example training with image noise.py" and its ``_safe``
variant: fine-tune + evaluate the multimodal BNN under underwater-
degradation augmentation across 6 turbidity centres linspace(0.05, 2.05)
(x 6 depth levels in the safe variant), with extended metrics: per-sample
CSVs, uncertainty-error AUROC, macro-F1, ECE + Emax (15 bins), and
Turbidity / Depth columns appended to the eval CSV.

Faithfulness note: the reference applies the UIFM to the *normalized*
optical tensor and clamps to [0, 1] (the dataset has already standardised
the image). Physically odd, but reproduced — parity beats physics here.

The degradation runs on the card (``engine/uifm.py``), on the batch the
steps receive. Where JAX splits a key per batch (turbidity, step), one
``torch.Generator`` feeds both here; the two packages agree on the
formula and the CSV schema, not on the sampled turbidities or weights.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.loaders import prepare_datasets_and_loaders
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine import metrics as MX
from multimodal_auv_torch.engine.loops import _device_batch, _fetch, select_patch
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    fresh_train_state,
    kl_annealing_weight,
    make_optimizer,
)
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.engine.uifm import degrade_uniform, sample_turbidity
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
    make_unimodal_bundle,
)

logger = logging.getLogger(__name__)

EVAL_CSV_HEADER = ["Epoch", "Model Type", "Test Loss", "Test Accuracy",
                   "Predictive Uncertainty", "Model Uncertainty",
                   "bathy Patch Type", "SSS Patch Type"]


def _build_inputs(batch, generator, turbidity_range, depth_value, modality,
                  bathy_patch_type, sss_patch_type, nominal, device):
    """Degraded input list + labels + mask on ``device`` for either
    modality, padded to ``nominal`` rows; the optical input is degraded
    on the device at a turbidity drawn from ``generator``. Returns
    (inputs, labels, mask, nominal rows)."""
    if modality == "multimodal":
        arrays = [batch["main_image"],
                  select_patch(batch, bathy_patch_type, "bathy"),
                  select_patch(batch, sss_patch_type, "sss")]
    else:  # unimodal optical
        arrays = [batch["main_image"]]
    inputs, labels, mask, _ = _device_batch(batch, arrays, nominal, device)
    inputs[0] = degrade_uniform(
        inputs[0], sample_turbidity(generator, turbidity_range), depth_value)
    return inputs, labels, mask, labels.shape[0]


def evaluate_with_degradation(
    eval_step, state: BayesTrainState, dataloader, epoch: int,
    total_num_epochs: int, csv_path: str, model_type: str,
    generator: torch.Generator,
    turbidity_range: Tuple[float, float], depth_value: float,
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    modality: str = "multimodal",
    strict_errors: bool = False,
) -> dict:
    """Degraded MC evaluation epoch with the noise study's extended metric
    set. Writes the standard eval CSV row, then appends AUROC / F1 / ECE /
    Emax / Turbidity / Depth and the per-sample CSV.

    ``strict_errors=False`` keeps the reference's behavior of logging and
    continuing when an extended metric cannot be computed (e.g. AUROC with
    a degenerate error set — "Example training with image noise.py"
    wraps each in try/except); ``True`` re-raises instead of shipping a
    sweep CSV with silently missing columns."""
    kl_weight = kl_annealing_weight(epoch, total_num_epochs)
    kl_scale = kl_weight / max(len(dataloader), 1)
    nominal = dataloader.batch_size
    device = state.post.mu.device

    total_loss = correct = total = 0.0
    all_pred, all_lab = [], []
    all_predictive, all_model_unc, all_alea = [], [], []
    all_mean_softmax = []

    for batch in dataloader:
        labels_np = np.asarray(batch["label"], np.int32)
        valid = labels_np.shape[0]
        inputs, labels, mask, _ = _build_inputs(
            batch, generator, turbidity_range, depth_value, modality,
            bathy_patch_type, sss_patch_type, nominal, device)
        raw = eval_step(state.post, state.batch_stats, inputs, labels, mask,
                        generator, kl_scale)
        # one device-to-host copy for all of this batch's metrics
        m = _fetch(raw)
        total_loss += float(m["loss"])
        correct += float(m["correct"])
        total += float(m["total"])
        all_pred.extend(m["predicted"][:valid])
        all_lab.extend(labels_np)
        all_predictive.extend(m["predictive_entropy"][:valid])
        all_model_unc.extend(m["model_uncertainty"][:valid])
        all_alea.extend(m["aleatoric_entropy"][:valid])
        all_mean_softmax.append(m["mean_prob"][:valid])

    accuracy = correct / max(total, 1.0)
    test_loss = total_loss / max(len(dataloader), 1)

    file_exists = os.path.isfile(csv_path)
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    with open(csv_path, "a", newline="") as f:
        w = csv.writer(f)
        if not file_exists:
            w.writerow(EVAL_CSV_HEADER)
        w.writerow([epoch + 1, model_type, test_loss, accuracy,
                    float(np.mean(all_predictive)) if all_predictive else 0.0,
                    float(np.mean(all_model_unc)) if all_model_unc else 0.0,
                    bathy_patch_type or "patch_30_bathy",
                    sss_patch_type or "patch_30_sss"])

    results = {"accuracy": accuracy, "loss": test_loss}

    MX.save_per_sample_metrics(
        csv_path, model_type, epoch, "30", "30", {
            "label": [int(x) for x in all_lab],
            "prediction": [int(x) for x in all_pred],
            "predictive_uncertainty": [float(x) for x in all_predictive],
            "epistemic_uncertainty": [float(x) for x in all_model_unc],
            "aleatoric_uncertainty": [float(x) for x in all_alea],
        })

    # AUROC / F1 / ECE / Emax + sweep coordinates
    extend = {}
    try:
        extend["uncertainty_error_auroc"] = "%.6f" % MX.uncertainty_error_auroc(
            all_pred, all_lab, all_predictive)
        results["auroc"] = float(extend["uncertainty_error_auroc"])
    except Exception as e:
        if strict_errors:
            raise
        logger.warning("Could not calculate Uncertainty-Error AUROC: %s", e)
    try:
        probs = np.concatenate(all_mean_softmax)
        f1 = MX.macro_f1(all_pred, all_lab)
        ece, emax = MX.calibration_metrics(probs, np.asarray(all_lab))
        extend.update({"F1_Score": "%.4f" % f1, "ECE": "%.4f" % ece,
                       "Emax": "%.4f" % emax})
        results.update({"f1": f1, "ece": ece, "emax": emax})
    except Exception as e:
        if strict_errors:
            raise
        logger.warning("Could not compute F1/ECE/Emax: %s", e)
    extend["Turbidity"] = "%.3f" % ((turbidity_range[0] + turbidity_range[1]) / 2)
    extend["Depth"] = str(depth_value)
    MX.append_fields_to_last_row(csv_path, extend)
    return results


def run_noise_study(
    root_dir: str,
    csv_dir: str,
    *,
    num_classes: int = 0,
    turbidity_centers: Optional[Sequence[float]] = None,
    turbidity_delta: float = 0.05,
    depth_levels: Sequence[float] = (1.0,),
    train_epochs_per_step: int = 0,
    num_mc: int = 5,
    batch_size: int = 4,
    lr: float = 1e-5,
    arch: Optional[ArchConfig] = None,
    model_weights_path: Optional[str] = None,
    seed: int = 0,
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    modality: str = "multimodal",
    strict_errors: bool = False,
    device: DeviceLike = None,
) -> List[dict]:
    """Sweep driver: 6 turbidity centers linspace(0.05, 2.05) x depth levels
    (pass 6 levels for the `_safe` variant). Per step: optional degraded
    fine-tuning epochs from the initial weights, then a degraded
    extended-metrics evaluation.

    ``modality='image'`` runs the unimodal variant ("Example unimodal
    training with image noise.py" — degradation on the optical input of a
    single-trunk BNN). ``strict_errors``: re-raise extended-metric
    failures instead of the reference's warn-and-continue (see
    evaluate_with_degradation). ``device``: None is the card (raises
    without one); ``"cpu"`` runs the kernels' plain versions."""
    dev = resolve_device(device)
    if turbidity_centers is None:
        turbidity_centers = np.linspace(0.05, 2.05, 6)
    arch = arch or ArchConfig()
    spec = BNNPriorSpec()

    (_, _, train_loader, test_loader, actual_classes, dataset) = (
        prepare_datasets_and_loaders(root_dir, batch_size_multimodal=batch_size,
                                     image_size=arch.image_size))
    if num_classes in (None, 0):
        num_classes = actual_classes

    gen = torch.Generator().manual_seed(seed)
    if modality == "multimodal":
        bundle = make_multimodal_bundle(num_classes, spec, gen, arch,
                                        device=dev)
    elif modality == "image":
        bundle = make_unimodal_bundle(3, num_classes, spec, gen, arch,
                                      device=dev)
    else:
        raise ValueError(f"unsupported noise-study modality {modality!r}")
    if model_weights_path:
        from multimodal_auv_torch.interop.torch_import import (
            load_and_prepare_multimodal_model,
        )

        bundle, _ = load_and_prepare_multimodal_model(
            bundle, model_weights_path, num_classes=num_classes)

    tx = make_optimizer(lr)
    eval_step = make_eval_step(bundle.module, bundle.meta, spec, num_mc)
    train_step = make_train_step(bundle.module, bundle.meta, spec, num_mc)
    os.makedirs(csv_dir, exist_ok=True)
    generator = torch.Generator().manual_seed(seed + 1)

    all_results = []
    for depth in depth_levels:
        for step_idx, center in enumerate(turbidity_centers):
            trange = (float(center) - turbidity_delta,
                      float(center) + turbidity_delta)
            logger.info("Degradation step %d/%d: turbidity %.2f depth %.2f",
                        step_idx + 1, len(turbidity_centers), center, depth)

            state = fresh_train_state(bundle.post, bundle.batch_stats, tx)
            total_epochs = max(train_epochs_per_step, 1)
            for ep in range(train_epochs_per_step):
                kl_weight = kl_annealing_weight(ep, total_epochs)
                for batch in train_loader:
                    inputs, labels, mask, _ = _build_inputs(
                        batch, generator, trange, depth, modality,
                        bathy_patch_type, sss_patch_type,
                        train_loader.batch_size, dev)
                    state, _ = train_step(
                        state, inputs, labels, mask, generator, kl_weight,
                        float(train_loader.batch_size))

            csv_path = os.path.join(
                csv_dir, f"noise_study_depth{depth}.csv")
            res = evaluate_with_degradation(
                eval_step, state, test_loader,
                epoch=step_idx, total_num_epochs=len(turbidity_centers),
                csv_path=csv_path, model_type=modality, generator=generator,
                turbidity_range=trange, depth_value=float(depth),
                bathy_patch_type=bathy_patch_type,
                sss_patch_type=sss_patch_type, modality=modality,
                strict_errors=strict_errors)
            res.update({"turbidity": float(center), "depth": float(depth)})
            all_results.append(res)
    return all_results
