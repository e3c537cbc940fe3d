"""run_AUV_training_from_scratch — multimodal training (port of
``multimodal_auv_tpu/pipelines/training.py``, single device).

Build the multimodal Bayesian bundle -> the labelled loaders (packed uint8
batches, or decoded folders) -> Adam + StepLR -> the MC-ELBO train step and
the MC eval step -> the epoch loops, with CSV ledgers, TensorBoard scalars,
a run manifest, checkpoints and cooperative preemption.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine.loops import train_and_evaluate_multimodal_model
from multimodal_auv_torch.engine.mc import not_ported
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    StepLR,
    make_optimizer,
)
from multimodal_auv_torch.engine.preemption import maybe_guard, null_guard
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.models.model_utils import ArchConfig, make_multimodal_bundle
from multimodal_auv_torch.utils.logging_utils import setup_pipeline_logging
from multimodal_auv_torch.utils.manifest import write_run_manifest
from multimodal_auv_torch.utils.tb import SummaryWriter

logger = logging.getLogger(__name__)


def _patch_type(base, kind: str) -> Optional[str]:
    if base is None:
        return None
    return f"patch_{base}_{kind}" if not str(base).startswith("patch_") else str(base)


def _train_multimodal_common(
    *,
    root_dir: str,
    bundle,
    num_classes: int,
    lr: float,
    weight_decay: float,
    num_epochs: int,
    num_mc: int,
    batch_size_multimodal: int,
    scheduler_step_size: int,
    scheduler_gamma: float,
    bathy_patch_base,
    sss_patch_base,
    spec: BNNPriorSpec,
    mc_chunk: int = 1,
    seed: int = 0,
    double_scheduler_step: bool = True,
    resume_checkpoint: Optional[str] = None,
    freeze_backbone: bool = False,
    bf16_weights: bool = False,
    use_packed_loader: bool = False,
    image_size: Optional[int] = None,
    strict_errors: bool = False,
    handle_preemption: bool = True,
    preemption_guard=None,
    remat: str = "on",
) -> BayesTrainState:
    if freeze_backbone:
        raise not_ported("freeze_backbone", "5 (training: freeze_backbone)")
    log_dir = setup_pipeline_logging()
    sum_writer = SummaryWriter(os.path.join("tensorboard_logs",
                                            os.path.basename(log_dir)))
    bathy_type = _patch_type(bathy_patch_base, "bathy")
    sss_type = _patch_type(sss_patch_base, "sss")
    if use_packed_loader:
        # decode-once epochs: uint8 memmap batches, normalised on the card
        from multimodal_auv_torch.data.loaders import prepare_packed_train_loaders

        train_loader, test_loader, actual_num_classes, dataset = (
            prepare_packed_train_loaders(
                root_dir, batch_size_multimodal, bathy_patch_type=bathy_type,
                sss_patch_type=sss_type, seed=seed, image_size=image_size))
    else:
        from multimodal_auv_torch.data.loaders import prepare_datasets_and_loaders

        (_, _, train_loader, test_loader, actual_num_classes, dataset) = (
            prepare_datasets_and_loaders(
                root_dir, batch_size_multimodal=batch_size_multimodal,
                image_size=image_size))
    if num_classes in (None, 0):
        num_classes = actual_num_classes
    elif num_classes != actual_num_classes:
        logger.warning("Configured num_classes (%d) differs from detected "
                       "(%d); using configured.", num_classes,
                       actual_num_classes)

    state = BayesTrainState(
        post=bundle.post,
        opt_state=make_optimizer(lr, weight_decay).init(bundle.post),
        batch_stats=bundle.batch_stats)
    train_step = make_train_step(
        bundle.module, bundle.meta, spec, num_mc, mc_chunk=mc_chunk,
        sample_dtype=torch.bfloat16 if bf16_weights else None,
        packed_inputs=use_packed_loader, remat=remat)
    eval_step = make_eval_step(bundle.module, bundle.meta, spec, num_mc,
                               mc_chunk=mc_chunk,
                               packed_inputs=use_packed_loader)
    scheduler = StepLR(lr, scheduler_step_size, scheduler_gamma)
    class_names = [str(c) for c in dataset.label_encoder.classes_]
    write_run_manifest(os.path.join(root_dir, "csvs"), "multimodal_training", {
        "root_dir": root_dir, "num_classes": num_classes, "lr": lr,
        "weight_decay": weight_decay, "num_epochs": num_epochs,
        "num_mc": num_mc, "batch_size": batch_size_multimodal,
        "scheduler_step_size": scheduler_step_size,
        "scheduler_gamma": scheduler_gamma,
        "bathy_patch_base": bathy_patch_base,
        "sss_patch_base": sss_patch_base, "seed": seed,
        "mc_chunk": mc_chunk, "double_scheduler_step": double_scheduler_step,
        "resume_checkpoint": resume_checkpoint, "bf16_weights": bf16_weights,
        "use_packed_loader": use_packed_loader, "image_size": image_size,
        "strict_errors": strict_errors, "remat": remat,
        "class_names": class_names,
    }, device=bundle.device)
    # SIGTERM stops at the next batch boundary and leaves the resume
    # checkpoint at the last completed epoch; a guard the caller entered
    # takes precedence over installing our own
    own = null_guard() if preemption_guard is not None else None
    with (own if own is not None else maybe_guard(handle_preemption)) as g:
        guard = preemption_guard if preemption_guard is not None else g
        state = train_and_evaluate_multimodal_model(
            train_loader, test_loader, num_epochs, train_step, eval_step,
            state, scheduler, os.path.join(root_dir, "csvs"), sum_writer,
            seed, bathy_patch_type=bathy_type, sss_patch_type=sss_type,
            class_names=class_names,
            double_scheduler_step=double_scheduler_step,
            checkpoint_resume_path=resume_checkpoint,
            strict_errors=strict_errors, preemption_guard=guard)
    if guard.triggered:
        logger.warning(
            "Training preempted (SIGTERM). %s",
            f"Resume with resume_checkpoint={resume_checkpoint!r}."
            if resume_checkpoint else
            "Pass resume_checkpoint= to make preempted runs resumable.")
    sum_writer.close()
    bundle.post = state.post
    bundle.batch_stats = state.batch_stats
    return state


def run_AUV_training_from_scratch(
    const_bnn_prior_parameters: Dict[str, Any],
    lr_multimodal_model: float,
    num_epochs_multimodal: int,
    num_mc: int,
    bathy_patch_base_raw: int,
    sss_patch_base_raw: int,
    batch_size_multimodal: int,
    root_dir: str,
    devices: Optional[List] = None,
    num_classes: int = 0,
    *,
    arch: Optional[ArchConfig] = None,
    mc_chunk: int = 1,
    seed: int = 0,
    weight_decay: float = 1e-5,
    scheduler_step_size: int = 7,
    scheduler_gamma: float = 0.752,
    resume_checkpoint: Optional[str] = None,
    pretrained_trunks: Optional[str] = None,
    bf16_weights: bool = False,
    use_packed_loader: bool = False,
    strict_errors: bool = False,
    async_checkpoints: bool = False,
    handle_preemption: bool = True,
    preemption_guard=None,
    mesh_spec=None,
    dist_spec=None,
    remat: str = "on",
    device: DeviceLike = None,
) -> bool:
    """Signature parity with the reference's functions.py:361-374
    (``devices`` is accepted and unused; ``device`` picks the card, or the
    CPU with ``device="cpu"``). Returns True when training finished, False
    when it raised (logged), as the reference does. Flags of paths not
    ported yet, and a missing card, raise before training starts."""
    for flag, value, item in (
            ("pretrained_trunks", pretrained_trunks, "9 (interop)"),
            ("async_checkpoints", async_checkpoints,
             "5 (training: async checkpoints)"),
            ("mesh_spec", mesh_spec, "8 (parallel)"),
            ("dist_spec", dist_spec, "8 (parallel)")):
        if value:
            raise not_ported(flag, item)
    if remat == "auto":
        raise not_ported("remat='auto'", "5 (training: remat='auto')")
    if remat in ("on", True) and mc_chunk > 4:
        raise not_ported("mc_chunk > 4 in training", "5 (training)")
    dev = resolve_device(device)
    try:
        spec = (BNNPriorSpec.from_dict(const_bnn_prior_parameters)
                if isinstance(const_bnn_prior_parameters, dict)
                else const_bnn_prior_parameters)
        arch = arch or ArchConfig()
        if num_classes in (None, 0):
            from multimodal_auv_torch.data.datasets import (
                MultimodalFolderDataset,
            )

            num_classes = MultimodalFolderDataset(root_dir).num_classes
        bundle = make_multimodal_bundle(num_classes, spec,
                                        torch.Generator().manual_seed(seed),
                                        arch, device=dev)
        _train_multimodal_common(
            root_dir=root_dir, bundle=bundle, num_classes=num_classes,
            lr=lr_multimodal_model, weight_decay=weight_decay,
            num_epochs=num_epochs_multimodal, num_mc=num_mc,
            batch_size_multimodal=batch_size_multimodal,
            scheduler_step_size=scheduler_step_size,
            scheduler_gamma=scheduler_gamma,
            bathy_patch_base=bathy_patch_base_raw,
            sss_patch_base=sss_patch_base_raw,
            spec=spec, mc_chunk=mc_chunk, seed=seed,
            resume_checkpoint=resume_checkpoint, bf16_weights=bf16_weights,
            use_packed_loader=use_packed_loader, strict_errors=strict_errors,
            handle_preemption=handle_preemption,
            preemption_guard=preemption_guard, remat=remat,
            image_size=arch.image_size)
        logger.info("Full training pipeline finished.")
        return True
    except Exception as e:  # the reference reports failure as False
        logger.exception("An error occurred during AUV training from "
                         "scratch: %s", e)
        return False
