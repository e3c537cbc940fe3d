"""run_auv_inference — the main path (port of
``multimodal_auv_tpu/pipelines/inference.py``).

Resolve the pretrained weights (a local bayesian-torch checkpoint, or the
HF Hub) into the multimodal Bayesian bundle -> an inference loader (packed
uint8 batches, or decoded folders) -> MC predict -> CSV in the reference
schema.
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
    "eval" (running statistics)."""
    if mesh_spec is not None:
        raise NotImplementedError(
            "mesh_spec is not ported yet: ROADMAP.md, Open items, "
            "1 'Modules to port' item 8 (parallel)")
    if use_dvp:
        raise NotImplementedError(
            "use_dvp is not ported yet: ROADMAP.md, Open items, "
            "1 'Modules to port' item 6 (DVP)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    logger = logging.getLogger(__name__)
    dev = resolve_device(device)
    logger.info("Using device: %s", dev)
    arch = arch or ArchConfig()
    bundle = pretrained_bundle(num_classes, BNNPriorSpec(), arch, seed,
                               model_weights_path, allow_random_init, dev)
    generator = torch.Generator().manual_seed(seed + 1)
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
        stale = True
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            stale = (meta.get("size") != arch.image_size
                     or meta.get("fingerprint") != inference_fingerprint(ds))
            if stale:
                logger.info("Packed cache %s is stale — repacking", cache)
        if stale:
            pack_inference_dataset(ds, cache, size=arch.image_size)
        multimodal_predict_and_save_packed(
            bundle, cache, output_csv, num_mc_samples=num_mc_samples,
            batch_size=batch_size, generator=generator, mc_chunk=mc_chunk,
            fast_sampling=fast_sampling, bn_mode=bn_mode, device=dev)
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
            fast_sampling=fast_sampling, bn_mode=bn_mode, device=dev)
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
