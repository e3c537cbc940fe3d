"""Unimodal pipelines: Bayesian classification from one modality (port of
``multimodal_auv_tpu/pipelines/unimodal.py``, on one device).

* ``unimodal_predict_and_save``: MC inference for one modality to the
  reference-schema CSV (BASELINE.json configs[0]: optical image, 10 MC).
* ``run_unimodal_training``: train and evaluate one unimodal BNN with its
  ledgers, confusion matrices, manifest and TensorBoard scalars
  (BASELINE.json configs[1]: side-scan sonar).
"""
from __future__ import annotations

import csv
import logging
import os
from typing import Iterable, Optional

import numpy as np
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.loaders import prepare_datasets_and_loaders
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine import uncertainty as U
from multimodal_auv_torch.engine.loops import (
    train_and_evaluate_unimodal_model,
    unimodal_input,
)
from multimodal_auv_torch.engine.mc import mc_logits
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    StepLR,
    full_posterior,
    make_optimizer,
)
from multimodal_auv_torch.engine.predict import (
    CSV_HEADER,
    _check_bn_mode,
    _placer,
)
from multimodal_auv_torch.engine.preemption import maybe_guard, null_guard
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    ModelBundle,
    make_unimodal_bundle,
)
from multimodal_auv_torch.parallel import mesh as M
from multimodal_auv_torch.parallel.distributed import (
    is_coordinator,
    maybe_initialize_distributed,
    process_count,
)
from multimodal_auv_torch.utils.manifest import write_run_manifest
from multimodal_auv_torch.utils.profiling import span
from multimodal_auv_torch.utils.tb import NullSummaryWriter, SummaryWriter

logger = logging.getLogger(__name__)

CHANNELS = {"image": 3, "bathy": 3, "sss": 1}


def unimodal_predict_and_save(
    bundle: ModelBundle,
    dataloader: Iterable,
    csv_path: str,
    num_mc_samples: int = 10,
    *,
    model_type: str = "image",
    generator: Optional[torch.Generator] = None,
    mc_chunk: int = 1,
    bn_mode: str = "train",
    device: DeviceLike = None,
) -> str:
    """MC inference for one modality: the CSV schema of the multimodal
    predictor, with the variance-estimator predictive uncertainty and the
    mean-entropy aleatoric one (eps 1e-7). Samples f32 weights on the
    stacked path (kernel #2, no gradient). Takes dict batches (labelled
    loaders) or (main, bathy, sss, names) tuples (inference loaders); a
    ragged batch is padded to the first batch's size by repeating its last
    row, with a mask that keeps the pad out of BN statistics, and each
    batch's rows are written while the next one runs. The JAX package's
    ``fast_sampling`` is not taken: it selects the noise of the split
    sampler, which this path does not use. ``bn_mode``: "train" (batch
    statistics, the reference's quirk) or "eval" (running statistics)."""
    _check_bn_mode(bn_mode)
    place = _placer(bundle, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module, meta = bundle.module, bundle.meta

    @torch.inference_mode()
    def step(x, mask):
        with span("auv.step"):
            logits = mc_logits(module, meta, bundle.post, bundle.batch_stats,
                               (x,), generator, num_mc_samples,
                               mc_chunk=mc_chunk, train=(bn_mode == "train"),
                               remat=False, batch_mask=mask)
            probs = U.softmax_probs(logits)
            # one (3, batch) tensor: a single copy to the host per batch
            return torch.stack([
                U.predicted_class(probs).to(torch.float32),
                U.variance_uncertainty(probs).to(torch.float32),
                U.aleatoric_uncertainty(probs, eps=1e-7).to(torch.float32)])

    nominal = None
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_HEADER)
        pending = None

        def drain(p):
            out, names, valid = p
            with span("auv.drain"):
                cols = out.cpu().numpy()
            for i in range(valid):
                name = names[i] if i < len(names) else f"sample_{i}"
                writer.writerow([name, int(cols[0, i]), float(cols[1, i]),
                                 float(cols[2, i])])

        for batch in dataloader:
            if isinstance(batch, dict):
                x = np.asarray(unimodal_input(batch, model_type))
                names = batch.get("name", [f"sample_{i}"
                                           for i in range(x.shape[0])])
            else:
                main, bathy, sss, names = batch
                x = np.asarray({"image": main, "bathy": bathy,
                                "sss": sss}[model_type])
            valid = x.shape[0]
            if nominal is None:
                nominal = valid
            mask = np.ones((nominal,), np.float32)
            if valid < nominal:
                mask[valid:] = 0.0
                x = np.concatenate([x, np.repeat(x[-1:], nominal - valid, 0)])
            out = step(place(x), place(mask))
            if pending is not None:
                drain(pending)
            pending = (out, names, valid)
        if pending is not None:
            drain(pending)
    logger.info("Unimodal %s inference written to %s", model_type, csv_path)
    return csv_path


def run_unimodal_training(
    root_dir: str,
    model_type: str = "sss",
    num_epochs: int = 10,
    num_mc: int = 5,
    batch_size: int = 8,
    lr: float = 1e-5,
    weight_decay: float = 1e-5,
    scheduler_step_size: int = 5,
    scheduler_gamma: float = 0.571,
    num_classes: int = 0,
    *,
    csv_dir: Optional[str] = None,
    arch: Optional[ArchConfig] = None,
    mc_chunk: int = 1,
    seed: int = 0,
    skip_epoch_zero: bool = True,
    strict_errors: bool = False,
    async_checkpoints: bool = False,
    resume_checkpoint: Optional[str] = None,
    handle_preemption: bool = True,
    preemption_guard=None,
    mesh_spec=None,
    dist_spec=None,
    device: DeviceLike = None,
) -> BayesTrainState:
    """Train and evaluate one unimodal BNN (``model_type`` "image", "bathy"
    or "sss") over a labelled survey tree: the folder loaders, a
    ``ResNet50Custom`` bundle, Adam with StepLR, the MC-ELBO train step
    (chunks of ``mc_chunk``, remat on) and the MC eval step, the epoch
    loops with their ledgers under ``csv_dir`` (default
    ``<root_dir>/csvs``), confusion matrices, a run manifest, TensorBoard
    scalars under ``<csv_dir>/tb``, and cooperative preemption
    (``handle_preemption``; ``resume_checkpoint`` makes a preempted run
    resumable). ``device``: the card unless ``"cpu"``. ``dist_spec`` (or
    the AUV_* environment) joins a process group, and ``mesh_spec`` lays
    the ranks out, as in ``run_AUV_training_from_scratch``.
    ``async_checkpoints``: the epoch loops' saves are written in the
    background (``engine/checkpointing.py``)."""
    if model_type not in CHANNELS:
        raise ValueError(f"Unknown model_type: {model_type}")
    maybe_initialize_distributed(dist_spec)
    if mesh_spec is not None:
        M.mesh_shape(mesh_spec)  # a layout the processes cannot run raises
    if process_count() > 1 and mesh_spec is None:
        raise ValueError("multi-process training needs a mesh_spec: the "
                         "global batch is split over the mesh's data axis")
    dev = resolve_device(device)
    arch = arch or ArchConfig()
    spec = BNNPriorSpec()
    (tl, te, _, _, actual_classes, dataset) = prepare_datasets_and_loaders(
        root_dir, batch_size_unimodal=batch_size, image_size=arch.image_size)
    if num_classes in (None, 0):
        num_classes = actual_classes

    bundle = make_unimodal_bundle(CHANNELS[model_type], num_classes, spec,
                                  torch.Generator().manual_seed(seed), arch,
                                  device=dev)
    tx = make_optimizer(lr, weight_decay)
    mesh = None
    if mesh_spec is not None:
        mesh, mc_chunk = M.training_mesh(mesh_spec, batch_size, num_mc,
                                         mc_chunk)
    state = BayesTrainState(post=bundle.post, opt_state=tx.init(bundle.post),
                            batch_stats=bundle.batch_stats)
    if mesh is not None:
        state = M.shard_state(mesh, state, tx, mesh.fsdp)
        # under fsdp the bundle holds the shard until the end (the whole mu
        # and rho are freed), then the gathered posterior
        bundle.post = state.post
    tstep = make_train_step(bundle.module, bundle.meta, spec, num_mc,
                            mc_chunk=mc_chunk, mesh=mesh)
    estep = make_eval_step(bundle.module, bundle.meta, spec, num_mc,
                           mc_chunk=mc_chunk, mesh=mesh)
    if mesh is not None:
        tl, te = M.shard_loaders(mesh, tl, te, packed=False)
        tstep = M.wrap_train_step(mesh, tstep)
        estep = M.wrap_eval_step(mesh, estep)
    csv_dir = csv_dir or os.path.join(root_dir, "csvs")
    manifest = {
        "root_dir": root_dir, "model_type": model_type,
        "num_epochs": num_epochs, "num_mc": num_mc,
        "batch_size": batch_size, "lr": lr, "weight_decay": weight_decay,
        "scheduler_step_size": scheduler_step_size,
        "scheduler_gamma": scheduler_gamma, "num_classes": num_classes,
        "seed": seed, "mc_chunk": mc_chunk,
        "skip_epoch_zero": skip_epoch_zero, "strict_errors": strict_errors,
        "async_checkpoints": async_checkpoints,
        "resume_checkpoint": resume_checkpoint,
        "mesh": (dict(data=mesh.data, mc=mesh.mc, fsdp=mesh.fsdp)
                 if mesh is not None else None),
        "num_processes": process_count(),
    }
    # rank 0 owns the ledgers, the manifest and the TB events
    if is_coordinator():
        write_run_manifest(csv_dir, "unimodal_training", manifest,
                           device=dev)
    sum_writer = (SummaryWriter(os.path.join(csv_dir, "tb"))
                  if is_coordinator() else NullSummaryWriter())
    # a guard the caller entered takes precedence over installing our own
    own = null_guard() if preemption_guard is not None else None
    with (own if own is not None else maybe_guard(handle_preemption)) as g:
        guard = preemption_guard if preemption_guard is not None else g
        state = train_and_evaluate_unimodal_model(
            tl, te, num_epochs, tstep, estep, state,
            StepLR(lr, scheduler_step_size, scheduler_gamma), csv_dir,
            sum_writer, seed + 1, model_type=model_type,
            class_names=[str(c) for c in dataset.label_encoder.classes_],
            skip_epoch_zero=skip_epoch_zero, strict_errors=strict_errors,
            async_checkpoints=async_checkpoints,
            checkpoint_resume_path=resume_checkpoint, preemption_guard=guard)
    if guard.triggered:
        logger.warning(
            "Unimodal training preempted (SIGTERM). %s",
            f"Resume with resume_checkpoint={resume_checkpoint!r}."
            if resume_checkpoint else
            "Pass resume_checkpoint= to make preempted runs resumable.")
    sum_writer.close()
    bundle.post = full_posterior(state)
    bundle.batch_stats = state.batch_stats
    return state
