"""Epoch loops and orchestration of multimodal and unimodal training (port
of ``multimodal_auv_tpu/engine/loops.py``).

The reference's ledgers and cadence are kept: the same CSV columns, the KL
annealing schedule, a posterior checkpoint every 5 epochs plus a
crash-save, the multimodal StepLR stepped twice per epoch (its
loop_utils.py:233, 246), and the unimodal loop's start at epoch 1 (its
off-by-one, ``skip_epoch_zero``). Randomness: each epoch's train and eval
generators are derived from the base seed and the absolute epoch index,
and the loaders' shuffle epoch is pinned to that index, so a run resumed
at epoch e replays an uninterrupted run exactly.

Under a process group every rank runs the loops on global-shaped batches
(the steps are wrapped by ``parallel/mesh.py``); rank 0 alone writes the
CSV ledgers and confusion matrices, and checkpoints
(``engine/checkpointing.py``).
"""
from __future__ import annotations

import csv
import io
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_auv_torch.engine import checkpointing as ckpt
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    StepLR,
    full_posterior,
    kl_annealing_weight,
    set_learning_rate,
)
from multimodal_auv_torch.engine.steps import (
    unfuse_eval_metrics,
    unfuse_train_metrics,
)
from multimodal_auv_torch.parallel.distributed import is_coordinator
from multimodal_auv_torch.utils.plotting import save_confusion_matrix
from multimodal_auv_torch.utils.profiling import span

logger = logging.getLogger(__name__)

TRAIN_CSV_HEADER = ["Epoch", "Model type", "Loss", "Accuracy", "lr",
                    "kl loss", "cross entropy loss", "SSS Patch Type",
                    "Channel Patch Type"]
EVAL_CSV_HEADER = ["Epoch", "Model Type", "Test Loss", "Test Accuracy",
                   "Predictive Uncertainty", "Model Uncertainty", "Scaled KL",
                   "Cross Entropy Loss", "bathy Patch Type", "SSS Patch Type"]
UNIMODAL_TRAIN_CSV_HEADER = ["Epoch", "Model type", "Loss", "Accuracy", "lr"]
UNIMODAL_EVAL_CSV_HEADER = ["Epoch", "Model Type", "Test Loss",
                            "Test Accuracy", "predictive_uncertainty",
                            "model_uncertainty"]


def epoch_generator(seed: int, index: int) -> torch.Generator:
    """The generator of stream ``index`` of base ``seed`` (the counterpart
    of ``jax.random.fold_in(key, index)``)."""
    word = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(word[0]))


def _patch_size_str(patch_type: Optional[str], kind: str) -> str:
    """'patch_30m_sss' -> '30m' (the reference's multimodal.py:178-179)."""
    if not patch_type:
        return "none"
    return patch_type.replace("patch_", "").replace(f"_{kind}", "")


def select_patch(batch: Dict, patch_type: Optional[str], kind: str) -> np.ndarray:
    """The reference's patch selection (multimodal.py:93-102): the patch
    of the resolved size, else the full-resolution tensor."""
    from multimodal_auv_torch.data.datasets import resolve_patch_size

    full = batch["bathy_image"] if kind == "bathy" else batch["sss_image"]
    patches = batch.get(f"patch_{kind}", {}) or {}
    size = resolve_patch_size(patch_type, kind, patches)
    return patches[size] if size is not None else full


def _fetch(m) -> dict:
    """A step's metrics on the host: one copy of its ``fused`` tensor."""
    with span("auv.drain"):
        vec = m["fused"].cpu().numpy()
    if "skipped" in m:  # train-step layout
        return unfuse_train_metrics(vec)
    return unfuse_eval_metrics(vec, m["predicted"].shape[0])


class _LaggedFetch:
    """One-batch-lagged device-to-host metrics: ``push`` returns the
    previous batch's metrics (or None) while the device runs the current
    one; ``flush`` drains the last."""

    def __init__(self):
        self._pending = None

    def push(self, item):
        prev, self._pending = self._pending, item
        return None if prev is None else (prev[0], _fetch(prev[1]))

    def flush(self):
        return self.push(None)


class _NullCSVWriter:
    """csv.writer stand-in for the ranks that own no ledger."""

    def writerow(self, row):
        pass


def _ledger_open(csv_path: str):
    """(file, writer, write_header) of an appended CSV ledger. Under a
    process group only rank 0 opens it: ``open(mode="a")`` creates the
    file, and would race rank 0's header-if-new check; the other ranks
    get an in-memory buffer and a writer that discards."""
    if not is_coordinator():
        return io.StringIO(), _NullCSVWriter(), False
    exists = os.path.isfile(csv_path)
    f = open(csv_path, mode="a", newline="")
    return f, csv.writer(f), not exists


def _pad_batch(arrays, labels, nominal: int):
    """Pad a ragged final batch to the nominal size by repeating its last
    row; returns (arrays, labels, mask) with mask 0.0 on the pad."""
    n = labels.shape[0]
    mask = np.ones((nominal,), np.float32)
    if n == nominal:
        return arrays, labels, mask
    pad = nominal - n
    mask[n:] = 0.0
    arrays = [np.concatenate([a, np.repeat(a[-1:], pad, 0)]) for a in arrays]
    labels = np.concatenate([labels, np.repeat(labels[-1:], pad, 0)])
    return arrays, labels, mask


def unimodal_input(batch: Dict, model_type: str) -> np.ndarray:
    """The reference's unimodal.py:113-122: image -> main, sss -> sss,
    bathy -> bathy."""
    key = {"image": "main_image", "sss": "sss_image",
           "bathy": "bathy_image"}.get(model_type)
    if key is None:
        raise ValueError(f"Unknown model_type: {model_type}")
    return batch[key]


def _device_batch(batch, inputs, nominal, device):
    """(inputs, labels, mask, n_valid) of a loader batch's ``inputs``,
    padded to the nominal size and placed on ``device``."""
    labels = np.asarray(batch["label"], np.int32)
    valid = labels.shape[0]
    inputs, labels, mask = _pad_batch([np.asarray(a) for a in inputs],
                                      labels, nominal)
    place = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    with span("auv.place"):
        return [place(a) for a in inputs], place(labels), place(mask), valid


def _multimodal_inputs(batch, bathy_patch_type, sss_patch_type):
    return [batch["main_image"],
            select_patch(batch, bathy_patch_type, "bathy"),
            select_patch(batch, sss_patch_type, "sss")]


def train_multimodal_model(
    train_step, state: BayesTrainState, dataloader, epoch: int,
    total_num_epochs: int, csv_path: str, model_type: str, sum_writer,
    generator: torch.Generator, lr: float,
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    strict_errors: bool = False,
    stop_check: Optional[Callable[[], bool]] = None,
    async_checkpoints: bool = False,
) -> Tuple[BayesTrainState, float, float]:
    """One training epoch (the reference's multimodal.py:25-202). Returns
    (state, train_loss, train_accuracy).

    ``strict_errors=False`` is the reference's behaviour: an exception
    mid-epoch crash-saves the posterior and returns zero metrics; ``True``
    crash-saves and re-raises. ``stop_check`` (engine/preemption.py) is
    polled each batch; when it turns true the loop stops at the batch
    boundary without the epoch's CSV row or 5-epoch checkpoint.
    ``async_checkpoints``: the 5-epoch checkpoint is written in the
    background (``checkpointing.save_model(async_save=True)``); the
    crash-save stays synchronous, so it drains the queue first."""
    csv_path = str(Path(csv_path))
    sss_size = _patch_size_str(sss_patch_type, "sss")
    bathy_size = _patch_size_str(bathy_patch_type, "bathy")
    name = f"{model_type}_bathy_patch{bathy_size}_sss_patch{sss_size}"
    device = state.post.mu.device
    try:
        csvfile, writer, write_header = _ledger_open(csv_path)
        with csvfile:
            if write_header:
                writer.writerow(TRAIN_CSV_HEADER)
            total_loss, correct, total = 0.0, 0.0, 0.0
            kl_weight = kl_annealing_weight(epoch, total_num_epochs)
            nominal = dataloader.batch_size
            last_kl, last_ce = 0.0, 0.0
            lag = _LaggedFetch()

            def account(done):
                nonlocal total_loss, correct, total, last_kl, last_ce
                if done is None:
                    return
                j, m = done
                loss = float(m["loss"])
                loss_bad = not np.isfinite(loss)
                if m["skipped"]:
                    logger.warning(
                        "Skipping %s %d due to NaN/Inf",
                        "batch" if loss_bad else "optimizer step for batch", j)
                # kl/ce are computed before the reference's NaN check, so
                # the last-batch columns update even for a skipped batch
                last_kl, last_ce = m["scaled_kl"], m["cross_entropy"]
                if loss_bad:
                    # the reference skips such a batch before any count
                    return
                total_loss += loss
                correct += m["correct"]
                total += m["total"]
                sum_writer.add_scalar("Loss/train", loss, j)

            preempted = False
            for i, batch in enumerate(dataloader):
                if stop_check is not None and stop_check():
                    logger.warning(
                        "Preemption requested — stopping train epoch %d at "
                        "batch %d (partial-epoch updates are discarded by a "
                        "checkpoint resume)", epoch, i)
                    preempted = True
                    break
                inputs, labels, mask, _ = _device_batch(
                    batch, _multimodal_inputs(batch, bathy_patch_type,
                                              sss_patch_type),
                    nominal, device)
                state, m = train_step(state, inputs, labels, mask, generator,
                                      kl_weight, float(nominal))
                account(lag.push((i, m)))
            account(lag.flush())

            train_accuracy = correct / max(total, 1.0)
            train_loss = total_loss / max(total, 1.0)
            if not preempted:
                logger.info("Epoch %d complete. Loss: %.4f, Accuracy: %.4f, "
                            "LR: %.6f", epoch + 1, train_loss, train_accuracy,
                            lr)
                writer.writerow([epoch, model_type, train_loss, train_accuracy,
                                 lr, last_kl, last_ce, sss_size, bathy_size])
        if epoch % 5 == 0 and not preempted:
            ckpt.save_model(full_posterior(state), csv_path, name,
                            async_save=async_checkpoints)
        return state, train_loss, train_accuracy
    except Exception:
        # crash-save, as the reference's bare except (multimodal.py:194-200)
        ckpt.save_model(full_posterior(state), csv_path, name)
        logger.error("Error at epoch %d", epoch, exc_info=True)
        if strict_errors:
            raise
        return state, 0.0, 0.0


def evaluate_multimodal_model(
    eval_step, state: BayesTrainState, dataloader, epoch: int,
    total_num_epochs: int, csv_path: str, model_type: str,
    generator: torch.Generator,
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    class_names=None,
    strict_errors: bool = False,
) -> float:
    """MC evaluation epoch (the reference's multimodal.py:204-369), with
    the entropy-decomposition uncertainty family; KL scaled by
    len(dataloader), then kl_weight. Returns test_accuracy."""
    csv_path = str(Path(csv_path))
    device = state.post.mu.device
    try:
        # under fsdp mu and rho are gathered once for the whole evaluation
        post = full_posterior(state)
        csvfile, writer, write_header = _ledger_open(csv_path)
        with csvfile:
            if write_header:
                writer.writerow(EVAL_CSV_HEADER)
            kl_weight = kl_annealing_weight(epoch, total_num_epochs)
            kl_scale = kl_weight / max(len(dataloader), 1)
            nominal = dataloader.batch_size
            total_loss, correct, total = 0.0, 0.0, 0.0
            all_pred, all_lab = [], []
            all_predictive, all_model_unc = [], []
            last_kl, last_ce = 0.0, 0.0
            lag = _LaggedFetch()

            def account(done):
                nonlocal total_loss, correct, total, last_kl, last_ce
                if done is None:
                    return
                (labels, valid), m = done
                total_loss += m["loss"]
                correct += m["correct"]
                total += m["total"]
                all_pred.extend(m["predicted"][:valid])
                all_lab.extend(labels[:valid])
                all_predictive.extend(m["predictive_entropy"][:valid])
                all_model_unc.extend(m["model_uncertainty"][:valid])
                last_kl, last_ce = m["kl_scaled"], m["cross_entropy"]

            for batch in dataloader:
                inputs, labels, mask, valid = _device_batch(
                    batch, _multimodal_inputs(batch, bathy_patch_type,
                                              sss_patch_type),
                    nominal, device)
                m = eval_step(post, state.batch_stats, inputs, labels,
                              mask, generator, kl_scale)
                account(lag.push(((np.asarray(batch["label"]), valid), m)))
            account(lag.flush())

            test_accuracy = correct / max(total, 1.0)
            test_loss = total_loss / max(len(dataloader), 1)
            if is_coordinator():
                save_confusion_matrix(all_lab, all_pred, csv_path,
                                      model_type, epoch, class_names)
            writer.writerow([
                epoch + 1, model_type, test_loss, test_accuracy,
                float(np.mean(all_predictive)) if all_predictive else 0.0,
                float(np.mean(all_model_unc)) if all_model_unc else 0.0,
                last_kl, last_ce,
                bathy_patch_type or "patch_30_bathy",
                sss_patch_type or "patch_30_sss",
            ])
            logger.info("Epoch %d: Test Loss: %.4f, Accuracy: %.4f",
                        epoch + 1, test_loss, test_accuracy)
        return test_accuracy
    except Exception as e:
        logger.error("Critical error at epoch %d: %s", epoch, e, exc_info=True)
        if strict_errors:
            raise
        return 0.0


def _resume(checkpoint_resume_path, state, model_type: str,
            scheduler: StepLR, start_epoch: int):
    """(state, first epoch) after restoring ``checkpoint_resume_path`` if it
    exists. A checkpoint without scheduler metadata, or saved for another
    ``model_type``, is refused: the unimodal trunks share parameter shapes,
    so another modality's checkpoint would load, skip every epoch and hand
    back its weights as this one's."""
    if not (checkpoint_resume_path and os.path.exists(checkpoint_resume_path)):
        return state, start_epoch
    state, resumed_epoch, sched = ckpt.restore_train_state(
        checkpoint_resume_path, state)
    if sched is None:
        raise ValueError(
            f"checkpoint {checkpoint_resume_path!r} has no scheduler "
            f"metadata — refusing a blind resume")
    if model_type not in sched:
        raise ValueError(
            f"checkpoint {checkpoint_resume_path!r} was saved for "
            f"model_type(s) {sorted(sched)} — refusing to resume "
            f"{model_type!r} from it (use one resume path per model)")
    scheduler.load_state_dict({"epoch_count": sched[model_type]})
    logger.info("Resumed from %s at epoch %d", checkpoint_resume_path,
                resumed_epoch)
    return state, max(start_epoch, resumed_epoch)


def train_and_evaluate_multimodal_model(
    train_loader, test_loader, num_epochs: int, train_step, eval_step,
    state: BayesTrainState, scheduler: StepLR, csv_dir: str,
    sum_writer, seed: int, model_type: str = "multimodal",
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    class_names=None,
    double_scheduler_step: bool = True,
    checkpoint_resume_path: Optional[str] = None,
    strict_errors: bool = False,
    async_checkpoints: bool = False,
    preemption_guard=None,
) -> BayesTrainState:
    """The reference's loop_utils.py:162-250: per epoch, train ->
    scheduler.step() -> eval -> scheduler.step() again (the reference's
    double step, ``double_scheduler_step=False`` to switch it off).

    ``checkpoint_resume_path``: the train state is saved there after every
    epoch and, if the file exists, restored first; a checkpoint without
    scheduler metadata, or of another ``model_type``, is refused.
    ``preemption_guard`` (engine/preemption.py): the train loop stops at
    the next batch boundary, and the orchestrator returns without eval or
    the epoch's save, so the resume point stays at the last completed
    epoch. ``async_checkpoints``: the epoch and 5-epoch saves are written
    in the background, and every write has committed when this returns
    or raises (``checkpointing.wait_for_saves``)."""
    os.makedirs(csv_dir, exist_ok=True)
    train_csv = os.path.join(csv_dir, "multimodal_train_results.csv")
    eval_csv = os.path.join(csv_dir, "multimodal_eval_results.csv")
    state, start_epoch = _resume(checkpoint_resume_path, state, model_type,
                                 scheduler, 0)
    stop_check = (preemption_guard.check if preemption_guard is not None
                  else None)
    # finally: a strict_errors re-raise must not leave background writes
    # in flight (the eval loop's crash-save is not the one that drains)
    try:
        for epoch in range(start_epoch, num_epochs):
            set_learning_rate(state.opt_state, scheduler.lr)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            state, train_loss, _ = train_multimodal_model(
                train_step, state, train_loader, epoch, num_epochs,
                train_csv, model_type, sum_writer,
                epoch_generator(seed, 2 * epoch), scheduler.lr,
                bathy_patch_type, sss_patch_type,
                strict_errors=strict_errors, stop_check=stop_check,
                async_checkpoints=async_checkpoints)
            if preemption_guard is not None and preemption_guard.triggered:
                logger.warning(
                    "Preempted during epoch %d — stopping without its "
                    "boundary save; resume%s replays it from the last "
                    "completed epoch", epoch,
                    f" ({checkpoint_resume_path})"
                    if checkpoint_resume_path else "")
                break
            scheduler.step()
            test_acc = evaluate_multimodal_model(
                eval_step, state, test_loader, epoch, num_epochs, eval_csv,
                model_type, epoch_generator(seed, 2 * epoch + 1),
                bathy_patch_type, sss_patch_type, class_names,
                strict_errors=strict_errors)
            if double_scheduler_step:
                scheduler.step()  # the reference's loop_utils.py:246
            sum_writer.add_scalar("Loss/train_epoch", train_loss, epoch)
            sum_writer.add_scalar("Accuracy/val_epoch", test_acc, epoch)
            if checkpoint_resume_path:
                ckpt.save_train_state(checkpoint_resume_path, state,
                                      epoch + 1,
                                      {model_type: scheduler.epoch_count},
                                      async_save=async_checkpoints)
            if preemption_guard is not None and preemption_guard.triggered:
                logger.warning("Preempted after completed epoch %d — "
                               "stopping cleanly", epoch)
                break
    finally:
        if async_checkpoints:
            ckpt.wait_for_saves()
    return state


def train_unimodal_model(
    train_step, state: BayesTrainState, dataloader, epoch: int,
    total_num_epochs: int, csv_path: str, model_type: str, sum_writer,
    generator: torch.Generator, lr: float, strict_errors: bool = False,
    stop_check: Optional[Callable[[], bool]] = None,
    async_checkpoints: bool = False,
) -> Tuple[BayesTrainState, float, float]:
    """One unimodal training epoch (the reference's unimodal.py:21-175);
    ledger columns ``UNIMODAL_TRAIN_CSV_HEADER``, the row logs epoch + 1.
    A non-finite loss is left out of the loss sum only; its batch still
    counts towards the accuracy, as in the reference.

    Returns (state, ACCURACY, LOSS): the reverse of
    ``train_multimodal_model``'s order, which is the reference's own
    asymmetry (its unimodal.py:175 against multimodal.py:202). Bind the
    outputs by name. ``strict_errors``, ``stop_check`` and
    ``async_checkpoints``: as in ``train_multimodal_model``."""
    csv_path = str(Path(csv_path))
    device = state.post.mu.device
    try:
        csvfile, writer, write_header = _ledger_open(csv_path)
        with csvfile:
            if write_header:
                writer.writerow(UNIMODAL_TRAIN_CSV_HEADER)
            total_loss, correct, total = 0.0, 0.0, 0.0
            kl_weight = kl_annealing_weight(epoch, total_num_epochs)
            nominal = dataloader.batch_size
            lag = _LaggedFetch()

            def account(done):
                nonlocal total_loss, correct, total
                if done is None:
                    return
                j, m = done
                loss = float(m["loss"])
                if np.isfinite(loss):
                    total_loss += loss
                correct += m["correct"]
                total += m["total"]
                sum_writer.add_scalar("Loss/train", loss, j)

            preempted = False
            for i, batch in enumerate(dataloader):
                if stop_check is not None and stop_check():
                    logger.warning(
                        "Preemption requested — stopping train epoch %d at "
                        "batch %d (partial-epoch updates are discarded by a "
                        "checkpoint resume)", epoch, i)
                    preempted = True
                    break
                inputs, labels, mask, _ = _device_batch(
                    batch, [unimodal_input(batch, model_type)], nominal,
                    device)
                state, m = train_step(state, inputs, labels, mask, generator,
                                      kl_weight, float(nominal))
                account(lag.push((i, m)))
            account(lag.flush())

            train_accuracy = correct / max(total, 1.0)
            train_loss = total_loss / max(total, 1.0)
            if not preempted:
                writer.writerow([epoch + 1, model_type, train_loss,
                                 train_accuracy, lr])
        if epoch % 5 == 0 and not preempted:
            ckpt.save_model(full_posterior(state), csv_path, model_type,
                            async_save=async_checkpoints)
        return state, train_accuracy, train_loss
    except Exception:
        ckpt.save_model(full_posterior(state), csv_path, model_type)
        logger.error("Error at epoch %d", epoch, exc_info=True)
        if strict_errors:
            raise
        return state, 0.0, 0.0


def evaluate_unimodal_model(
    eval_step, state: BayesTrainState, dataloader, epoch: int,
    total_num_epochs: int, csv_path: str, model_type: str,
    generator: torch.Generator, class_names=None,
    strict_errors: bool = False,
) -> float:
    """Unimodal MC eval (the reference's unimodal.py:178-365): the
    variance-estimator epistemic and mean-entropy aleatoric (eps 1e-7)
    columns, the KL divided by the batch size (its unimodal.py:272, 278),
    ledger columns ``UNIMODAL_EVAL_CSV_HEADER``. An exception crash-saves
    the posterior. Returns the accuracy."""
    csv_path = str(Path(csv_path))
    device = state.post.mu.device
    try:
        # under fsdp mu and rho are gathered once for the whole evaluation
        post = full_posterior(state)
        csvfile, writer, write_header = _ledger_open(csv_path)
        with csvfile:
            if write_header:
                writer.writerow(UNIMODAL_EVAL_CSV_HEADER)
            kl_weight = kl_annealing_weight(epoch, total_num_epochs)
            nominal = dataloader.batch_size
            kl_scale = kl_weight / nominal
            total_loss, correct, total = 0.0, 0.0, 0.0
            all_pred, all_lab, all_epi, all_alea = [], [], [], []
            lag = _LaggedFetch()

            def account(done):
                nonlocal total_loss, correct, total
                if done is None:
                    return
                (labels, valid), m = done
                total_loss += m["loss"]
                correct += m["correct"]
                total += m["total"]
                all_pred.extend(m["predicted"][:valid])
                all_lab.extend(labels[:valid])
                all_epi.extend(m["epistemic_variance"][:valid])
                all_alea.extend(m["aleatoric_mc_entropy"][:valid])

            for batch in dataloader:
                inputs, labels, mask, valid = _device_batch(
                    batch, [unimodal_input(batch, model_type)], nominal,
                    device)
                m = eval_step(post, state.batch_stats, inputs, labels,
                              mask, generator, kl_scale)
                account(lag.push(((np.asarray(batch["label"]), valid), m)))
            account(lag.flush())

            accuracy = correct / max(total, 1.0)
            avg_loss = total_loss / max(total, 1.0)
            if is_coordinator():
                save_confusion_matrix(all_lab, all_pred, csv_path,
                                      model_type, epoch, class_names)
            writer.writerow([
                epoch + 1, model_type, avg_loss, accuracy,
                float(np.mean(all_epi)) if all_epi else 0.0,
                float(np.mean(all_alea)) if all_alea else 0.0,
            ])
        return accuracy
    except Exception:
        ckpt.save_model(full_posterior(state), csv_path, model_type)
        logger.error("Error at epoch %d", epoch, exc_info=True)
        if strict_errors:
            raise
        return 0.0


def train_and_evaluate_unimodal_model(
    train_loader, test_loader, num_epochs: int, train_step, eval_step,
    state: BayesTrainState, scheduler: StepLR, csv_dir: str, sum_writer,
    seed: int, model_type: str, class_names=None,
    skip_epoch_zero: bool = True, strict_errors: bool = False,
    async_checkpoints: bool = False,
    checkpoint_resume_path: Optional[str] = None,
    preemption_guard=None,
) -> BayesTrainState:
    """The reference's loop_utils.py:65-159: per epoch train -> eval ->
    scheduler.step(). Its epoch loop is ``range(1, num_epochs)``, which
    skips epoch 0; kept by default, ``skip_epoch_zero=False`` runs it.
    ``checkpoint_resume_path``, ``preemption_guard`` and
    ``async_checkpoints``: as in ``train_and_evaluate_multimodal_model``;
    a checkpoint of another modality is refused."""
    os.makedirs(csv_dir, exist_ok=True)
    train_csv = os.path.join(csv_dir,
                             f"unimodal_{model_type}_train_results.csv")
    eval_csv = os.path.join(csv_dir, f"unimodal_{model_type}_eval_results.csv")
    state, start = _resume(checkpoint_resume_path, state, model_type,
                           scheduler, 1 if skip_epoch_zero else 0)
    stop_check = (preemption_guard.check if preemption_guard is not None
                  else None)
    try:  # as in train_and_evaluate_multimodal_model
        for epoch in range(start, num_epochs):
            set_learning_rate(state.opt_state, scheduler.lr)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            state, _, train_loss = train_unimodal_model(
                train_step, state, train_loader, epoch, num_epochs,
                train_csv, model_type, sum_writer,
                epoch_generator(seed, 2 * epoch), scheduler.lr,
                strict_errors=strict_errors, stop_check=stop_check,
                async_checkpoints=async_checkpoints)
            if preemption_guard is not None and preemption_guard.triggered:
                logger.warning(
                    "Preempted during epoch %d — stopping without its "
                    "boundary save; resume%s replays it from the last "
                    "completed epoch", epoch,
                    f" ({checkpoint_resume_path})"
                    if checkpoint_resume_path else "")
                break
            test_acc = evaluate_unimodal_model(
                eval_step, state, test_loader, epoch, num_epochs, eval_csv,
                model_type, epoch_generator(seed, 2 * epoch + 1),
                class_names, strict_errors=strict_errors)
            scheduler.step()
            sum_writer.add_scalar(f"Loss/train_{model_type}", train_loss,
                                  epoch)
            sum_writer.add_scalar(f"Accuracy/val_{model_type}", test_acc,
                                  epoch)
            if checkpoint_resume_path:
                ckpt.save_train_state(checkpoint_resume_path, state,
                                      epoch + 1,
                                      {model_type: scheduler.epoch_count},
                                      async_save=async_checkpoints)
            if preemption_guard is not None and preemption_guard.triggered:
                logger.warning("Preempted after completed epoch %d — "
                               "stopping cleanly", epoch)
                break
    finally:
        if async_checkpoints:
            ckpt.wait_for_saves()
    return state
