"""run_AUV_training_from_scratch and run_auv_retraining — multimodal
training (port of ``multimodal_auv_tpu/pipelines/training.py``).

Build the multimodal Bayesian bundle (random, MOPED from torchvision-named
trunks, or a bayesian-torch checkpoint with the fc2 head swapped) -> the
labelled loaders (packed uint8 batches, or decoded folders) -> Adam (gated
under ``freeze_backbone``) + StepLR -> the MC-ELBO train step and the MC
eval step -> the epoch loops, with CSV ledgers, TensorBoard scalars, a run
manifest, checkpoints and cooperative preemption.

The reference's retraining builds its optimizer over a fresh model instead
of the loaded one (its functions.py:229-235), so the loaded weights are
never optimized; as in the JAX package, the optimizer here owns the
trained posterior.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine.loops import train_and_evaluate_multimodal_model
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    StepLR,
    make_backbone_freeze_mask,
    make_optimizer,
    make_optimizer_with_freeze,
)
from multimodal_auv_torch.engine.preemption import maybe_guard, null_guard
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.models.model_utils import ArchConfig, make_multimodal_bundle
from multimodal_auv_torch.parallel import mesh as M
from multimodal_auv_torch.parallel.distributed import (
    is_coordinator,
    maybe_initialize_distributed,
    process_count,
)
from multimodal_auv_torch.pipelines.inference import pretrained_bundle
from multimodal_auv_torch.utils.logging_utils import setup_pipeline_logging
from multimodal_auv_torch.utils.manifest import write_run_manifest
from multimodal_auv_torch.utils.tb import NullSummaryWriter, SummaryWriter

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
    async_checkpoints: bool = False,
    handle_preemption: bool = True,
    preemption_guard=None,
    remat: str = "on",
    mesh_spec=None,
) -> BayesTrainState:
    log_dir = setup_pipeline_logging()
    # rank 0 owns every ledger: TB events, manifest, CSV rows
    # (engine/loops.py) and checkpoint files (engine/checkpointing.py)
    sum_writer = (SummaryWriter(os.path.join("tensorboard_logs",
                                             os.path.basename(log_dir)))
                  if is_coordinator() else NullSummaryWriter())
    multi = process_count() > 1
    if multi and mesh_spec is None:
        raise ValueError("multi-process training needs a mesh_spec: the "
                         "global batch is split over the mesh's data axis")
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

    if freeze_backbone:
        # only the optimizer is gated: the running statistics still update
        tx = make_optimizer_with_freeze(
            lr, weight_decay, make_backbone_freeze_mask(bundle.meta,
                                                        bundle.post))
    else:
        tx = make_optimizer(lr, weight_decay)
    # data parallelism over the mesh's data axis, MC-ensemble parallelism
    # over its mc axis, optional FSDP of the Adam moments; the epoch loops
    # are untouched: the steps are wrapped, the loaders sharded
    mesh = None
    if mesh_spec is not None:
        mesh, mc_chunk = M.training_mesh(mesh_spec, batch_size_multimodal, num_mc,
                                   mc_chunk)
    fsdp = mesh is not None and mesh.fsdp
    state = BayesTrainState(post=bundle.post, opt_state=tx.init(bundle.post),
                            batch_stats=bundle.batch_stats)
    if mesh is not None:
        state = M.shard_state(mesh, state, tx, fsdp)
    train_step = make_train_step(
        bundle.module, bundle.meta, spec, num_mc, mc_chunk=mc_chunk,
        sample_dtype=torch.bfloat16 if bf16_weights else None,
        packed_inputs=use_packed_loader, remat=remat, mesh=mesh)
    eval_step = make_eval_step(bundle.module, bundle.meta, spec, num_mc,
                               mc_chunk=mc_chunk,
                               packed_inputs=use_packed_loader, mesh=mesh)
    if mesh is not None:
        train_loader, test_loader = M.shard_loaders(
            mesh, train_loader, test_loader, use_packed_loader)
        train_step = M.wrap_train_step(mesh, train_step)
        eval_step = M.wrap_eval_step(mesh, eval_step)
        logger.info("Training on mesh %s (fsdp=%s), process %d/%d",
                    mesh.shape, fsdp, mesh.rank, mesh.world_axis.size)
    scheduler = StepLR(lr, scheduler_step_size, scheduler_gamma)
    class_names = [str(c) for c in dataset.label_encoder.classes_]
    manifest = {
        "root_dir": root_dir, "num_classes": num_classes, "lr": lr,
        "weight_decay": weight_decay, "num_epochs": num_epochs,
        "num_mc": num_mc, "batch_size": batch_size_multimodal,
        "scheduler_step_size": scheduler_step_size,
        "scheduler_gamma": scheduler_gamma,
        "bathy_patch_base": bathy_patch_base,
        "sss_patch_base": sss_patch_base, "seed": seed,
        "mc_chunk": mc_chunk, "double_scheduler_step": double_scheduler_step,
        "resume_checkpoint": resume_checkpoint,
        "freeze_backbone": freeze_backbone, "bf16_weights": bf16_weights,
        "use_packed_loader": use_packed_loader, "image_size": image_size,
        "strict_errors": strict_errors,
        "async_checkpoints": async_checkpoints, "remat": remat,
        "class_names": class_names,
        "mesh": (dict(data=mesh.data, mc=mesh.mc, fsdp=fsdp)
                 if mesh is not None else None),
        "num_processes": process_count(),
    }
    if is_coordinator():
        write_run_manifest(os.path.join(root_dir, "csvs"),
                           "multimodal_training", manifest,
                           device=bundle.device)
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
            strict_errors=strict_errors,
            async_checkpoints=async_checkpoints, preemption_guard=guard)
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


def _spec(const_bnn_prior_parameters) -> BNNPriorSpec:
    if isinstance(const_bnn_prior_parameters, dict):
        return BNNPriorSpec.from_dict(const_bnn_prior_parameters)
    return const_bnn_prior_parameters or BNNPriorSpec()


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
    CPU with ``device="cpu"``). ``dist_spec`` (or the AUV_* environment)
    joins a process group first, one process per card; ``mesh_spec`` lays
    the ranks out (``parallel/mesh.py``): data x mc must equal the number
    of processes. Returns True when training finished, False
    when it raised (logged), as the reference does. A missing card raises
    before training starts. ``async_checkpoints``: the epoch loops' saves
    are written in the background (``engine/checkpointing.py``);
    ``remat``: "on", "off" or "auto" (``engine/steps.py``).

    ``pretrained_trunks``: a torchvision-named ResNet-50 state dict that
    MOPED-initialises all three feature trunks, the offline stand-in for
    the reference's IMAGENET1K_V1 download."""
    maybe_initialize_distributed(dist_spec)
    if mesh_spec is not None:
        M.mesh_shape(mesh_spec)  # a layout the processes cannot run raises
    dev = resolve_device(device)
    try:
        spec = _spec(const_bnn_prior_parameters)
        arch = arch or ArchConfig()
        if num_classes in (None, 0):
            from multimodal_auv_torch.data.datasets import (
                MultimodalFolderDataset,
            )

            num_classes = MultimodalFolderDataset(root_dir).num_classes
        bundle = make_multimodal_bundle(num_classes, spec,
                                        torch.Generator().manual_seed(seed),
                                        arch, device=dev)
        if pretrained_trunks:
            from multimodal_auv_torch.interop.torch_import import (
                init_trunks_from_torchvision,
                load_torch_state_dict,
            )

            sd = load_torch_state_dict(pretrained_trunks)
            post, bs, st = init_trunks_from_torchvision(bundle, sd, spec=spec)
            bundle.post, bundle.batch_stats = post, bs
            logger.info("Pretrained trunk init from %s: %s",
                        pretrained_trunks, st)
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
            async_checkpoints=async_checkpoints,
            handle_preemption=handle_preemption,
            preemption_guard=preemption_guard, remat=remat,
            image_size=arch.image_size, mesh_spec=mesh_spec)
        logger.info("Full training pipeline finished.")
        return True
    except Exception as e:  # the reference reports failure as False
        logger.exception("An error occurred during AUV training from "
                         "scratch: %s", e)
        return False


def run_auv_retraining(
    root_dir: str,
    devices: Optional[List] = None,
    const_bnn_prior_parameters: Optional[Dict[str, Any]] = None,
    num_classes: int = 7,
    lr_multimodal: float = 1e-5,
    multimodal_weight_decay: float = 1e-5,
    epochs_multimodal: int = 20,
    num_mc: int = 5,
    bathy_patch_base: int = 30,
    sss_patch_base: int = 30,
    batch_size_multimodal: int = 1,
    scheduler_multimodal_step_size: int = 7,
    scheduler_multimodal_gamma: float = 0.752,
    *,
    model_weights_path: Optional[str] = None,
    allow_random_init: bool = False,
    arch: Optional[ArchConfig] = None,
    mc_chunk: int = 1,
    seed: int = 0,
    resume_checkpoint: Optional[str] = None,
    freeze_backbone: bool = False,
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
    """Foundation-model retraining (the reference's functions.py:84-258):
    the pretrained checkpoint (``model_weights_path``, else the HF Hub),
    fc2 swapped for a fresh head when ``num_classes`` != 7, then multimodal
    fine-tuning. ``freeze_backbone=True`` trains only the fusion head
    (attention_*, fc / fc1 / fc2), BASELINE configs[3]'s frozen-backbone
    workload. Without weights it raises unless ``allow_random_init``.
    Returns True when training finished, False when it raised (logged);
    a missing card raises before. ``async_checkpoints`` and ``remat``: as
    in ``run_AUV_training_from_scratch``."""
    maybe_initialize_distributed(dist_spec)
    if mesh_spec is not None:
        M.mesh_shape(mesh_spec)  # a layout the processes cannot run raises
    dev = resolve_device(device)
    try:
        spec = _spec(const_bnn_prior_parameters)
        arch = arch or ArchConfig()
        bundle = pretrained_bundle(num_classes, spec, arch, seed,
                                   model_weights_path, allow_random_init, dev)
        _train_multimodal_common(
            root_dir=root_dir, bundle=bundle, num_classes=num_classes,
            lr=lr_multimodal, weight_decay=multimodal_weight_decay,
            num_epochs=epochs_multimodal, num_mc=num_mc,
            batch_size_multimodal=batch_size_multimodal,
            scheduler_step_size=scheduler_multimodal_step_size,
            scheduler_gamma=scheduler_multimodal_gamma,
            bathy_patch_base=bathy_patch_base,
            sss_patch_base=sss_patch_base,
            spec=spec, mc_chunk=mc_chunk, seed=seed,
            resume_checkpoint=resume_checkpoint,
            freeze_backbone=freeze_backbone, bf16_weights=bf16_weights,
            use_packed_loader=use_packed_loader, strict_errors=strict_errors,
            async_checkpoints=async_checkpoints,
            handle_preemption=handle_preemption,
            preemption_guard=preemption_guard, remat=remat,
            image_size=arch.image_size, mesh_spec=mesh_spec)
        return True
    except Exception as e:  # the reference reports failure as False
        logger.exception("An error occurred during retraining: %s", e)
        return False
