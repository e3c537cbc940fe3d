"""MC inference and the reference-schema CSV (port of
``multimodal_auv_tpu/engine/predict.py``).

One row per sample: ["Image Name", "Predicted Class", "Predictive
Uncertainty", "Aleatoric Uncertainty"], where predictive uncertainty is the
MC variance estimator and aleatoric the mean MC entropy (eps 1e-7).
"""
from __future__ import annotations

import csv
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


def _check_bn_mode(bn_mode: str) -> None:
    if bn_mode not in ("train", "eval"):
        raise ValueError(f"bn_mode must be 'train' or 'eval', got {bn_mode!r}")


def _default_chunk(num_mc_samples: int, mc_chunk: Optional[int]) -> int:
    # chunk 2 reads (mu, sigma) once for two draws
    if mc_chunk is None:
        return 2 if num_mc_samples % 2 == 0 else 1
    return mc_chunk


def make_predict_step(bundle: ModelBundle, num_mc_samples: int, *,
                      mc_chunk: Optional[int] = None,
                      sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                      fast_sampling: Optional[bool] = None,
                      bn_mode: str = "train") -> Callable:
    """(post, batch_stats, inputs, generator, mask) -> outputs dict, over
    already-normalised float NHWC inputs.

    ``sample_dtype=bfloat16`` (default) casts the posterior once and samples
    straight to bf16 weights. ``bn_mode``: "train" (reference-faithful,
    batch statistics) or "eval" (frozen running statistics)."""
    _check_bn_mode(bn_mode)
    mc_chunk = _default_chunk(num_mc_samples, mc_chunk)
    module, meta = bundle.module, bundle.meta

    @torch.inference_mode()
    def step(post, batch_stats, inputs, generator, mask=None):
        logits = mc_logits(module, meta, post, batch_stats, inputs, generator,
                           num_mc_samples, mc_chunk=mc_chunk,
                           train=(bn_mode == "train"), remat=False,
                           sample_dtype=sample_dtype, batch_mask=mask,
                           split_sampling=True,
                           fast_sampling=fast_sampling)
        return _mc_outputs(logits)

    return step


def make_packed_logits_fn(bundle: ModelBundle, *, mc_chunk: int,
                          sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                          fast_sampling: Optional[bool] = None,
                          bn_mode: str = "train") -> Callable:
    """(post, batch_stats, u8_inputs, seeds, mask) -> (nchunks * mc_chunk,
    batch, C) logits over uint8 NHWC batches, chunk k's draws from row k
    of ``seeds`` ((nchunks, 2) int64 on the device): the packed predict
    step as a function of tensors, which ``serving.py`` exports. The
    /255 + optical normalisation runs on the device (ops/preprocess.py)."""
    _check_bn_mode(bn_mode)
    module, meta = bundle.module, bundle.meta

    def logits_fn(post, batch_stats, u8_inputs, seeds, mask=None):
        return split_mc_logits(module, meta, post, batch_stats,
                               normalize_multimodal(*u8_inputs), seeds,
                               mc_chunk=mc_chunk, train=(bn_mode == "train"),
                               sample_dtype=sample_dtype, batch_mask=mask,
                               fast_sampling=fast_sampling)

    return logits_fn


def make_packed_predict_step(bundle: ModelBundle, num_mc_samples: int, *,
                             mc_chunk: Optional[int] = None,
                             sample_dtype: Optional[torch.dtype] = torch.bfloat16,
                             fast_sampling: Optional[bool] = None,
                             bn_mode: str = "train") -> Callable:
    """Predict step over uint8 NHWC batches: the /255 + optical
    normalisation runs on the device (ops/preprocess.py). The chunks' seeds
    are drawn from the generator on the host and go to the device as one
    tensor (``make_packed_logits_fn``), with no wait on the device."""
    mc_chunk = _default_chunk(num_mc_samples, mc_chunk)
    if num_mc_samples % mc_chunk != 0:
        raise ValueError(f"num_mc={num_mc_samples} must be divisible by "
                         f"mc_chunk={mc_chunk}")
    logits_fn = make_packed_logits_fn(bundle, mc_chunk=mc_chunk,
                                      sample_dtype=sample_dtype,
                                      fast_sampling=fast_sampling,
                                      bn_mode=bn_mode)
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
) -> None:
    """Inference over a packed (decode-once) dataset (data/packing.py), same
    CSV schema as ``multimodal_predict_and_save``. ``step``: a prebuilt
    ``make_packed_predict_step`` result to reuse across surveys."""
    from multimodal_auv_torch.data.packing import PackedBatches, load_packed

    place = _placer(bundle, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    batches = PackedBatches(load_packed(packed_dir), batch_size)
    if step is None:
        step = make_packed_predict_step(bundle, num_mc_samples,
                                        mc_chunk=mc_chunk,
                                        fast_sampling=fast_sampling,
                                        bn_mode=bn_mode)
    with open(csv_path, mode="w", newline="") as csvfile:
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
) -> None:
    """Iterate an inference loader of (main, bathy, sss, names) batches of
    normalised float NHWC arrays and write the reference-schema CSV."""
    place = _placer(bundle, device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if step is None:
        step = make_predict_step(bundle, num_mc_samples, mc_chunk=mc_chunk,
                                 fast_sampling=fast_sampling, bn_mode=bn_mode)
    logger.info("CSV will be saved to: %s", csv_path)
    with open(csv_path, mode="w", newline="") as csvfile:
        writer = csv.writer(csvfile)
        writer.writerow(CSV_HEADER)
        _serve_batches(step, bundle.post, bundle.batch_stats, place,
                       dataloader, writer, generator)
    logger.info("Completed: multimodal_predict_and_save")
