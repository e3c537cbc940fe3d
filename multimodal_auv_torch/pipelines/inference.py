"""run_auv_inference — the main path — and export_auv_serving_artifact
(port of ``multimodal_auv_tpu/pipelines/inference.py``).

Resolve the pretrained weights (a local bayesian-torch checkpoint, or the
HF Hub) into the multimodal Bayesian bundle -> an inference loader (packed
uint8 batches, or decoded folders) -> MC predict -> CSV in the reference
schema; or the same bundle -> an exported serving artifact (serving.py).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.interop import hub
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    ModelBundle,
    make_multimodal_bundle,
)
from multimodal_auv_torch.parallel.distributed import (
    barrier,
    is_coordinator,
    maybe_initialize_distributed,
)
from multimodal_auv_torch.parallel.mesh import make_mesh


def run_auv_inference(
    data_directory,
    batch_size: int = 4,
    output_csv: str = "./inference_results.csv",
    num_mc_samples: int = 5,
    num_classes: int = 7,
    *,
    model_weights_path: Optional[str] = None,
    allow_random_init: bool = False,
    arch: Optional[ArchConfig] = None,
    mc_chunk: Optional[int] = None,
    seed: int = 0,
    use_packed_loader: bool = False,
    packed_cache_dir: Optional[str] = None,
    mesh_spec=None,
    use_dvp: bool = False,
    fast_sampling: Optional[bool] = None,
    bn_mode: str = "train",
    device: DeviceLike = None,
):
    """Multimodal BNN inference over one survey directory or a list of them.

    ``model_weights_path``: a local bayesian-torch checkpoint (the
    published ``pytorch_model.bin`` or an export of either package); without
    it the HF Hub's is fetched, and where there is none (offline, or no
    ``huggingface_hub``) the model is random and ``allow_random_init=True``
    is required. ``use_packed_loader`` decodes
    once into a uint8 cache (``packed_cache_dir``, default
    ``<dir>/.packed_cache_<size>``) that is repacked when stale.
    ``fast_sampling``: None = bf16-budget noise exactly when sampling to
    bf16. ``bn_mode``: "train" (batch statistics, the reference's quirk) or
    "eval" (running statistics). ``use_dvp``: the single-pass DVP step
    (engine/moment.py) with its guardrail set to fall back to exact MC
    (``on_excess="mc"``); ``fast_sampling`` and ``bn_mode`` do not reach
    it (the fallback takes their defaults), as in the JAX package.

    ``mesh_spec`` (config.MeshSpec, over the process group that the AUV_*
    environment or the caller set up, one process per card): each batch's
    rows go over the data axis (``batch_size`` must divide by it), the MC
    draws over the mc axis; DVP runs its trunks over the data axis. Every
    rank runs the pipeline; rank 0 packs the cache and writes the CSV."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    logger = logging.getLogger(__name__)
    maybe_initialize_distributed()
    dev = resolve_device(device)
    mesh = None if mesh_spec is None else make_mesh(mesh_spec)
    logger.info("Using device: %s", dev)
    arch = arch or ArchConfig()
    bundle = pretrained_bundle(num_classes, BNNPriorSpec(), arch, seed,
                               model_weights_path, allow_random_init, dev)
    generator = torch.Generator().manual_seed(seed + 1)
    step = None
    if use_dvp:
        from multimodal_auv_torch.engine.moment import make_dvp_predict_step

        # built here, so mc_chunk reaches the guardrail's exact-MC fallback
        step = make_dvp_predict_step(bundle, num_mc_samples, on_excess="mc",
                                     packed_inputs=use_packed_loader,
                                     mc_chunk=mc_chunk, mesh=mesh)
    dirs = ([data_directory] if isinstance(data_directory, (str, bytes))
            else list(data_directory))
    if use_packed_loader:
        from multimodal_auv_torch.data.datasets import (
            ConcatDataset,
            InferenceFolderDataset,
        )
        from multimodal_auv_torch.data.packing import (
            inference_fingerprint,
            pack_inference_dataset,
        )
        from multimodal_auv_torch.engine.predict import (
            multimodal_predict_and_save_packed,
        )

        cache = packed_cache_dir or os.path.join(
            dirs[0], f".packed_cache_{arch.image_size}")
        datasets = [InferenceFolderDataset(d, image_size=arch.image_size)
                    for d in dirs]
        ds = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
        # the cache is keyed by dirs[0] only: check it was packed from this
        # directory list and on-disk state
        meta_path = os.path.join(cache, "pack_meta.json")
        if is_coordinator():  # the other ranks read what rank 0 packs
            stale = True
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                stale = (meta.get("size") != arch.image_size
                         or meta.get("fingerprint")
                         != inference_fingerprint(ds))
                if stale:
                    logger.info("Packed cache %s is stale — repacking",
                                cache)
            if stale:
                pack_inference_dataset(ds, cache, size=arch.image_size)
        barrier()
        multimodal_predict_and_save_packed(
            bundle, cache, output_csv, num_mc_samples=num_mc_samples,
            batch_size=batch_size, generator=generator, mc_chunk=mc_chunk,
            fast_sampling=fast_sampling, bn_mode=bn_mode, step=step,
            device=dev, mesh=mesh)
    else:
        from multimodal_auv_torch.data.loaders import (
            prepare_inference_datasets_and_loaders,
        )
        from multimodal_auv_torch.engine.predict import (
            multimodal_predict_and_save,
        )

        dataloader = prepare_inference_datasets_and_loaders(
            dirs, batch_size, image_size=arch.image_size)
        multimodal_predict_and_save(
            bundle, dataloader, output_csv, num_mc_samples=num_mc_samples,
            generator=generator, mc_chunk=mc_chunk,
            fast_sampling=fast_sampling, bn_mode=bn_mode, step=step,
            device=dev, mesh=mesh)
    logger.info("Final inference process completed successfully.")
    return output_csv


def pretrained_bundle(num_classes: int, spec: BNNPriorSpec, arch: ArchConfig,
                      seed: int, model_weights_path: Optional[str],
                      allow_random_init: bool,
                      dev: torch.device) -> ModelBundle:
    """The multimodal bundle with the pretrained weights (a local
    checkpoint or the HF Hub's) imported, fc2 dropped when ``num_classes``
    differs from the checkpoint's; the random init where there are none,
    if ``allow_random_init`` allows it, else RuntimeError."""
    logger = logging.getLogger(__name__)
    bundle = make_multimodal_bundle(num_classes, spec,
                                    torch.Generator().manual_seed(seed), arch,
                                    device=dev)
    weights = hub.fetch_pretrained_weights(local_path=model_weights_path)
    if weights is not None:
        from multimodal_auv_torch.interop.torch_import import (
            load_and_prepare_multimodal_model,
        )

        bundle, stats = load_and_prepare_multimodal_model(
            bundle, weights, num_classes=num_classes)
        logger.info("Pretrained weights loaded: %s", stats)
    elif not allow_random_init:
        raise RuntimeError(
            "No pretrained weights available (offline and no "
            "model_weights_path). Pass allow_random_init=True to proceed "
            "with a randomly initialised model.")
    else:
        logger.warning("Proceeding with randomly initialised model.")
    return bundle


def export_auv_serving_artifact(
    output_dir: str,
    batch_size=4,  # int, or "poly" for a batch-polymorphic artifact
    num_mc_samples: int = 20,
    num_classes: int = 7,
    *,
    model_weights_path: Optional[str] = None,
    allow_random_init: bool = False,
    arch: Optional[ArchConfig] = None,
    mc_chunk: Optional[int] = None,
    seed: int = 0,
    platforms=None,
    use_dvp: bool = False,
    dvp_on_excess: str = "mc",
    data_shards: int = 1,
    mc_shards: int = 1,
    fast_sampling: Optional[bool] = None,
    bn_mode: str = "train",
    device: DeviceLike = None,
):
    """Export a serving artifact (serving.py): the packed MC predict
    programs + posterior state, loadable on a serving host with torch,
    numpy and the port's ops alone (no model code, no Hub access, no
    tracing). The bundle is built and the programs traced on ``device``
    (None = the card), where the artifact then serves.

    ``use_dvp`` exports the single-pass DVP program instead (same ABI;
    guardrailed at export time by ``dvp_on_excess``, see serving.py).
    ``mc_shards`` > 1 exports an mc-sharded artifact (serving.py: one
    shard's program of the stacked sampler, run by the loader on
    ``mc_shards`` devices). ``data_shards`` > 1 exports a batch-sharded
    artifact (serving.py: one data shard's program, whose BN statistics
    the loader's shard workers sum through ``auv::shard_sum``); the two
    compose, on data_shards x mc_shards devices."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    dev = resolve_device(device)
    arch = arch or ArchConfig()
    bundle = pretrained_bundle(num_classes, BNNPriorSpec(), arch, seed,
                               model_weights_path, allow_random_init, dev)
    from multimodal_auv_torch.serving import export_predict_artifact

    return export_predict_artifact(
        bundle, output_dir, batch_size=batch_size,
        num_mc_samples=num_mc_samples, image_size=arch.image_size,
        mc_chunk=mc_chunk, platforms=platforms, seed=seed,
        mode="dvp" if use_dvp else "mc", dvp_on_excess=dvp_on_excess,
        data_shards=data_shards, mc_shards=mc_shards,
        fast_sampling=fast_sampling, bn_mode=bn_mode)
