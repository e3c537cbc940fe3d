"""Model construction (port of ``multimodal_auv_tpu/models/model_utils.py``:
``ModelBundle``, ``ArchConfig``, ``make_multimodal_bundle``).

Weights are initialised on the CPU from a ``torch.Generator`` and then moved
to the device, so one seed gives the same bundle on the CPU and the card.
Without pretrained weights the trunks are random; MOPED then sets
sigma = moped_delta * |w|.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_auv_torch.bayes.packing import (
    PackedPosterior,
    PackMeta,
    bayesianize,
    tree_to,
)
from multimodal_auv_torch.config import IMAGE_SIZE, BNNPriorSpec
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.models.fusion import MultiModalModel


@dataclass
class ModelBundle:
    """A Bayesian model: the (weightless) module, the packed posterior, its
    layout and the BatchNorm running statistics."""

    module: nn.Module
    post: PackedPosterior
    meta: PackMeta
    batch_stats: Dict[str, Any]

    @property
    def device(self) -> torch.device:
        return self.post.mu.device

    def apply_with_weights(self, w_flat: torch.Tensor, *inputs,
                           train: bool = True, batch_mask=None,
                           batch_stats=None) -> torch.Tensor:
        """Forward with an explicit flat weight vector."""
        params = self.meta.unpack(w_flat, self.post.det)
        stats = self.batch_stats if batch_stats is None else batch_stats
        return self.module(params, stats, *inputs, train=train,
                           batch_mask=batch_mask)


@dataclass(frozen=True)
class ArchConfig:
    """Backbone scaling knobs; the default is the full ResNet-50 geometry.
    Parameters are f32; ``dtype`` is the activation dtype."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    image_size: int = IMAGE_SIZE
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, image_size: int = 32):
        """Same topology, 1 block per stage, width 8, f32 (tests)."""
        return cls(stage_sizes=(1, 1, 1, 1), width=8, image_size=image_size,
                   dtype=torch.float32)

    @classmethod
    def micro(cls, image_size: int = 32):
        """Two stages, width 8, f32 (engine and pipeline tests)."""
        return cls(stage_sizes=(1, 1), width=8, image_size=image_size,
                   dtype=torch.float32)


def multimodal_module(num_classes: int, arch: ArchConfig) -> MultiModalModel:
    return MultiModalModel(num_classes=num_classes,
                           stage_sizes=arch.stage_sizes, width=arch.width,
                           dtype=arch.dtype)


def make_multimodal_bundle(num_classes: int, spec: BNNPriorSpec,
                           generator: Optional[torch.Generator] = None,
                           arch: ArchConfig = ArchConfig(), *,
                           device: DeviceLike = None) -> ModelBundle:
    """Random-init multimodal bundle, MOPED-bayesianized, on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module = multimodal_module(num_classes, arch)
    params, stats = module.init(generator)
    post, meta = bayesianize(params, spec)
    return ModelBundle(module=module, post=post.to(dev), meta=meta,
                       batch_stats=tree_to(stats, dev))
