"""MC inference and the reference-schema CSV (port of
``multimodal_auv_tpu/engine/predict.py``).

One row per sample: ["Image Name", "Predicted Class", "Predictive
Uncertainty", "Aleatoric Uncertainty"], where predictive uncertainty is the
MC variance estimator and aleatoric the mean MC entropy (eps 1e-7).
"""
from __future__ import annotations

import csv
import io
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine import uncertainty as U
from multimodal_auv_torch.engine.mc import mc_logits, split_mc_logits
from multimodal_auv_torch.models.model_utils import ModelBundle
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.ops.sampling import chunk_seed_words
from multimodal_auv_torch.parallel.collectives import bn_sync, gather_rows
from multimodal_auv_torch.parallel.distributed import host_rows, is_coordinator

logger = logging.getLogger(__name__)

CSV_HEADER = ["Image Name", "Predicted Class",
              "Predictive Uncertainty", "Aleatoric Uncertainty"]


def _mc_outputs(logits: torch.Tensor):
    """The predict steps' shared output schema."""
    probs = U.softmax_probs(logits)
    pred = U.predicted_class(probs)
    pu = U.variance_uncertainty(probs)
    au = U.aleatoric_uncertainty(probs, eps=1e-7)
    return {
        "predicted": pred,
        "predictive_uncertainty": pu,
        "aleatoric_uncertainty": au,
        "mean_prob": U.mean_probs(probs),
        # one (3, batch) f32 tensor: the CSV columns in a single copy to host
        "csv_cols": torch.stack([pred.to(torch.float32), pu.to(torch.float32),
                                 au.to(torch.float32)]),
    }


def fused_outputs(logits: torch.Tensor) -> torch.Tensor:
    """The serving ABI's one (3 + C, batch) f32 tensor from (num_mc, batch,
    C) logits: rows predicted, predictive and aleatoric uncertainty, then
    mean_prob transposed (one device-to-host copy per batch)."""
    out = _mc_outputs(logits)
    return torch.cat([out["csv_cols"], out["mean_prob"].to(torch.float32).T])


def _unfuse_outputs(fused: torch.Tensor):
    """The outputs dict of a (3 + C, batch) ``fused_outputs`` tensor."""
    return {
        "predicted": fused[0].to(torch.int64),
        "predictive_uncertainty": fused[1],
        "aleatoric_uncertainty": fused[2],
        "mean_prob": fused[3:].T,
        "csv_cols": fused[:3],
    }


def mesh_predict_step(logits_of: Callable, mesh) -> Callable:
    """A predict step over a mesh (``parallel/mesh.py``) from ``logits_of
    (post, batch_stats, inputs, generator, mask) -> (num_mc, rows, C)``,
    which runs on this rank's rows: the step takes the global batch, hands
    its data rank's rows to ``logits_of`` with BatchNorm statistics over
    the data axis, and gathers the (3 + C, rows) ``fused_outputs`` over the
    data axis (one all_reduce) into the global batch's outputs, the same
    on every rank."""

    @torch.inference_mode()
    def step(post, batch_stats, inputs, generator, mask=None):
        rows = lambda a: host_rows(mesh, a)
        with bn_sync(mesh.data_axis):
            logits = logits_of(post, batch_stats, [rows(a) for a in inputs],
                               generator, None if mask is None else rows(mask))
        fused = gather_rows(fused_outputs(logits).T.contiguous(),
                            mesh.data_axis).T
        return _unfuse_outputs(fused)

    return step


def _check_bn_mode(bn_mode: str, fused_trunks: bool = False) -> None:
    if bn_mode not in ("train", "eval"):
        raise ValueError(f"bn_mode must be 'train' or 'eval', got {bn_mode!r}")
    if fused_trunks and bn_mode == "eval":
        # the grouped trunks compute train-mode BN only
        raise ValueError("fused_trunks=True supports bn_mode='train' only: "
                         "the grouped trunks normalise by batch statistics")


def _module(bundle: ModelBundle, fused_trunks: bool):
    """The bundle's module, or its grouped-trunk twin (models/fused.py)."""
    if not fused_trunks:
        return bundle.module
    from multimodal_auv_torch.models.fused import fused_module_for

    return fused_module_for(bundle.module)


def _default_chunk(num_mc_samples: int, mc_chunk: Optional[int],
                   antithetic: bool = False) -> int:
    # chunk 2 reads (mu, sigma) once for two draws; an antithetic chunk of
    # 1 already runs two
    if mc_chunk is None:
        return 2 if num_mc_samples % 2 == 0 and not antithetic else 1
    return mc_chunk


def _mc_logits_of(bundle: ModelBundle, num_mc_samples: int, mc_chunk: int,
                  sample_dtype, fast_sampling, bn_mode: str,
                  fused_trunks: bool, packed: bool, mesh=None,
                  antithetic: bool = False,
                  pipelined: bool = False) -> Callable:
    """(post, batch_stats, inputs, generator, mask) -> MC logits over
    normalised float inputs, or uint8 ones with ``packed``; under a mesh
    with an mc axis the draws are split over it (the stacked sampler).
    ``antithetic`` and ``pipelined``: as in ``mc_logits``."""
    module, meta = _module(bundle, fused_trunks), bundle.meta
    ws = None if mesh is None or mesh.mc == 1 else mesh

    def logits_of(post, batch_stats, inputs, generator, mask=None):
        if packed:
            inputs = normalize_multimodal(*inputs)
        return mc_logits(module, meta, post, batch_stats, inputs, generator,
                         num_mc_samples, mc_chunk=mc_chunk,
                         train=(bn_mode == "train"), remat=False,
                         sample_dtype=sample_dtype, batch_mask=mask,
                         split_sampling=True, fast_sampling=fast_sampling,
                         ws_sharding=ws, antithetic=antithetic,
                         pipelined=pipelined)

    return logits_of


def make_predict_step(bundle: ModelBundle, num_mc_samples: int, *,
                      mc_chunk: Optional[int] = None,
                      sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                      fast_sampling: Optional[bool] = None,
                      bn_mode: str = "train", fused_trunks: bool = False,
                      antithetic: bool = False, pipelined: bool = False,
                      mesh=None) -> Callable:
    """(post, batch_stats, inputs, generator, mask) -> outputs dict, over
    already-normalised float NHWC inputs.

    ``sample_dtype=bfloat16`` (default) casts the posterior once and samples
    straight to bf16 weights. ``bn_mode``: "train" (reference-faithful,
    batch statistics) or "eval" (frozen running statistics).
    ``fused_trunks``: the grouped-conv trunks (models/fused.py), train-mode
    BN only (with "eval" it raises). ``mesh``: rows over the data axis and
    draws over the mc axis (``mesh_predict_step``); the mc chunk defaults
    to all draws then, so every chunk spans the mc axis. ``antithetic``:
    each draw paired with its mirror 2 mu - w (the stacked sampler; the
    chunk defaults to 1, i.e. two draws). ``pipelined``: chunk k + 1
    sampled on a second CUDA stream during chunk k's forwards, the same
    logits (``engine/mc.py``)."""
    _check_bn_mode(bn_mode, fused_trunks)
    if mesh is not None and mesh.mc > 1 and mc_chunk is None:
        mc_chunk = num_mc_samples // (2 if antithetic else 1)
    mc_chunk = _default_chunk(num_mc_samples, mc_chunk, antithetic)
    logits_of = _mc_logits_of(bundle, num_mc_samples, mc_chunk, sample_dtype,
                              fast_sampling, bn_mode, fused_trunks, False,
                              mesh, antithetic, pipelined)
    if mesh is not None:
        return mesh_predict_step(logits_of, mesh)

    @torch.inference_mode()
    def step(post, batch_stats, inputs, generator, mask=None):
        return _mc_outputs(logits_of(post, batch_stats, inputs, generator,
                                     mask))

    return step


def make_packed_logits_fn(bundle: ModelBundle, *, mc_chunk: int,
                          sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                          fast_sampling: Optional[bool] = None,
                          bn_mode: str = "train",
                          fused_trunks: bool = False,
                          pipelined: bool = False) -> Callable:
    """(post, batch_stats, u8_inputs, seeds, mask) -> (nchunks * mc_chunk,
    batch, C) logits over uint8 NHWC batches, chunk k's draws from row k
    of ``seeds`` ((nchunks, 2) int64 on the device): the packed predict
    step as a function of tensors, which ``serving.py`` exports. The
    /255 + optical normalisation runs on the device (ops/preprocess.py).
    ``fused_trunks``: the grouped-conv trunks (models/fused.py).
    ``pipelined``: the same logits with the sampling of chunk k + 1 on a
    second CUDA stream (``split_mc_logits``; not for ``torch.export``)."""
    _check_bn_mode(bn_mode, fused_trunks)
    module, meta = _module(bundle, fused_trunks), bundle.meta

    def logits_fn(post, batch_stats, u8_inputs, seeds, mask=None):
        return split_mc_logits(module, meta, post, batch_stats,
                               normalize_multimodal(*u8_inputs), seeds,
                               mc_chunk=mc_chunk, train=(bn_mode == "train"),
                               sample_dtype=sample_dtype, batch_mask=mask,
                               fast_sampling=fast_sampling,
                               pipelined=pipelined)

    return logits_fn


def make_packed_predict_step(bundle: ModelBundle, num_mc_samples: int, *,
                             mc_chunk: Optional[int] = None,
                             sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                             fast_sampling: Optional[bool] = None,
                             bn_mode: str = "train",
                             fused_trunks: bool = False,
                             pipelined: bool = False,
                             mesh=None) -> Callable:
    """Predict step over uint8 NHWC batches: the /255 + optical
    normalisation runs on the device (ops/preprocess.py). The chunks' seeds
    are drawn from the generator on the host and go to the device as one
    tensor (``make_packed_logits_fn``), with no wait on the device.
    ``fused_trunks``: the grouped-conv trunks (models/fused.py), train-mode
    BN only; the split sampler (#1) still draws the weights. ``pipelined``:
    chunk k + 1 sampled on a second CUDA stream during chunk k's forwards,
    outputs equal to the split step's (the JAX package's packed step takes
    the flag and drops it). ``mesh``: as in ``make_predict_step`` (the
    pipelined hint is inactive under an mc axis)."""
    _check_bn_mode(bn_mode, fused_trunks)
    if mesh is not None and mesh.mc > 1 and mc_chunk is None:
        mc_chunk = num_mc_samples
    mc_chunk = _default_chunk(num_mc_samples, mc_chunk)
    if num_mc_samples % mc_chunk != 0:
        raise ValueError(f"num_mc={num_mc_samples} must be divisible by "
                         f"mc_chunk={mc_chunk}")
    if mesh is not None:
        return mesh_predict_step(_mc_logits_of(
            bundle, num_mc_samples, mc_chunk, sample_dtype, fast_sampling,
            bn_mode, fused_trunks, True, mesh, pipelined=pipelined), mesh)
    logits_fn = make_packed_logits_fn(bundle, mc_chunk=mc_chunk,
                                      sample_dtype=sample_dtype,
                                      fast_sampling=fast_sampling,
                                      bn_mode=bn_mode,
                                      fused_trunks=fused_trunks,
                                      pipelined=pipelined)
    nchunks = num_mc_samples // mc_chunk

    @torch.inference_mode()
    def step(post, batch_stats, u8_inputs, generator, mask=None):
        seeds = chunk_seed_words(generator, nchunks).to(post.mu.device,
                                                        non_blocking=True)
        return _mc_outputs(logits_fn(post, batch_stats, u8_inputs, seeds,
                                     mask))

    return step


def _serve_batches(step, post, batch_stats, place, batches: Iterable, writer,
                   generator: torch.Generator, nominal: Optional[int] = None
                   ) -> None:
    """The serving loop shared by the packed and folder paths.

    Pads a ragged batch to the nominal size by repeating its last row, with
    a validity mask that keeps the pad out of BN statistics, then launches
    batch k and drains batch k-1: the copy of k-1's CSV columns to the host
    waits only for k-1, while batch k's kernels are already queued.
    ``nominal=None`` adopts the first batch's size and grows if a later
    batch exceeds it."""
    pending = None

    def drain(p):
        out, names, valid = p
        cols = out["csv_cols"].cpu().numpy()  # one copy for all rows
        pred, pu, au = cols[0].astype(np.int64), cols[1], cols[2]
        for i in range(valid):
            name = (names[i] if isinstance(names, (list, tuple, np.ndarray))
                    else names)
            writer.writerow([name, int(pred[i]), float(pu[i]), float(au[i])])

    for main, bathy, sss, names in batches:
        main, bathy, sss = (np.asarray(main), np.asarray(bathy),
                            np.asarray(sss))
        valid = main.shape[0]
        if nominal is None or valid > nominal:
            nominal = valid
        mask = np.ones((nominal,), bool)
        if valid < nominal:
            pad = nominal - valid
            mask[valid:] = False
            main = np.concatenate([main, np.repeat(main[-1:], pad, 0)])
            bathy = np.concatenate([bathy, np.repeat(bathy[-1:], pad, 0)])
            sss = np.concatenate([sss, np.repeat(sss[-1:], pad, 0)])
        out = step(post, batch_stats, (place(main), place(bathy), place(sss)),
                   generator, place(mask))
        if pending is not None:
            drain(pending)
        pending = (out, names, valid)
    if pending is not None:
        drain(pending)


def _check_rows(batch_size: Optional[int], mesh) -> None:
    if mesh is not None and batch_size and batch_size % mesh.data:
        raise ValueError(f"batch_size ({batch_size}) must be divisible by "
                         f"the mesh 'data' axis ({mesh.data})")


def _csv_open(csv_path: str):
    """The CSV file, on rank 0; an in-memory sink on the other ranks of a
    process group (every rank runs the serving loop)."""
    if is_coordinator():
        return open(csv_path, mode="w", newline="")
    return io.StringIO()


def _placer(bundle: ModelBundle, device: DeviceLike):
    dev = resolve_device(device)
    if bundle.device.type != dev.type:
        raise ValueError(f"bundle is on {bundle.device}, asked to run on {dev}")
    return lambda a: torch.from_numpy(np.array(a)).to(dev)


def multimodal_predict_and_save_packed(
    bundle: ModelBundle, packed_dir: str, csv_path: str,
    num_mc_samples: int = 10, batch_size: int = 4, *,
    generator: Optional[torch.Generator] = None,
    mc_chunk: Optional[int] = None, fast_sampling: Optional[bool] = None,
    bn_mode: str = "train", step=None, device: DeviceLike = None,
    mesh=None,
) -> None:
    """Inference over a packed (decode-once) dataset (data/packing.py), same
    CSV schema as ``multimodal_predict_and_save``. ``step``: a prebuilt
    ``make_packed_predict_step`` result to reuse across surveys.
    ``mesh``: rows over its data axis, draws over its mc axis
    (``make_packed_predict_step(mesh=)``); every rank runs the loop, rank
    0 writes the CSV. ``batch_size`` must divide by the data axis."""
    from multimodal_auv_torch.data.packing import PackedBatches, load_packed

    place = _placer(bundle, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    _check_rows(batch_size, mesh)
    batches = PackedBatches(load_packed(packed_dir), batch_size)
    if step is None:
        step = make_packed_predict_step(bundle, num_mc_samples,
                                        mc_chunk=mc_chunk,
                                        fast_sampling=fast_sampling,
                                        bn_mode=bn_mode, mesh=mesh)
    with _csv_open(csv_path) as csvfile:
        writer = csv.writer(csvfile)
        writer.writerow(CSV_HEADER)
        _serve_batches(step, bundle.post, bundle.batch_stats, place, batches,
                       writer, generator, nominal=batch_size)


def multimodal_predict_and_save(
    bundle: ModelBundle, dataloader: Iterable, csv_path: str,
    num_mc_samples: int = 10, *,
    generator: Optional[torch.Generator] = None,
    mc_chunk: Optional[int] = None, fast_sampling: Optional[bool] = None,
    bn_mode: str = "train", step=None, device: DeviceLike = None,
    mesh=None, sss_patch_type: Optional[str] = "",
    channel_patch_type: Optional[str] = "", model_type: str = "multimodal",
) -> None:
    """Iterate an inference loader of (main, bathy, sss, names) batches of
    normalised float NHWC arrays and write the reference-schema CSV.
    ``mesh``: as in ``multimodal_predict_and_save_packed`` (the loader's
    batch size must divide by the data axis). ``sss_patch_type``,
    ``channel_patch_type`` and ``model_type`` are the reference's
    signature, accepted and unused, as in the JAX package: the loader's
    batches already hold the patches."""
    del sss_patch_type, channel_patch_type, model_type
    place = _placer(bundle, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    _check_rows(getattr(dataloader, "batch_size", None), mesh)
    if step is None:
        step = make_predict_step(bundle, num_mc_samples, mc_chunk=mc_chunk,
                                 fast_sampling=fast_sampling, bn_mode=bn_mode,
                                 mesh=mesh)
    logger.info("CSV will be saved to: %s", csv_path)
    with _csv_open(csv_path) as csvfile:
        writer = csv.writer(csvfile)
        writer.writerow(CSV_HEADER)
        _serve_batches(step, bundle.post, bundle.batch_stats, place,
                       dataloader, writer, generator)
    logger.info("Completed: multimodal_predict_and_save")
