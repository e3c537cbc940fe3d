"""Model construction (port of ``multimodal_auv_tpu/models/model_utils.py``):
``ModelBundle``, ``ArchConfig``, the bundle makers, and ``define_models``,
``load_models`` and ``move_models_to_device``.

Weights are initialised on the CPU from a ``torch.Generator`` and then moved
to the device, so one seed gives the same bundle on the CPU and the card.
Without pretrained weights the trunks are random; MOPED then sets
sigma = moped_delta * |w|. Loading pretrained trunks (torchvision, orbax or
bayesian-torch files) is not ported yet and raises, naming its ROADMAP item.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_auv_torch.bayes.packing import (
    PackedPosterior,
    PackMeta,
    bayesianize,
    sample_weights,
    tree_to,
)
from multimodal_auv_torch.config import IMAGE_SIZE, BNNPriorSpec
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.engine.mc import not_ported
from multimodal_auv_torch.models.fusion import MultiModalModel
from multimodal_auv_torch.models.resnet import (
    ResNet,
    ResNet50Custom,
    forward_layout,
)

logger = logging.getLogger(__name__)


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
                           batch_stats=None, mutable: bool = False):
        """Forward with an explicit flat weight vector; with ``mutable``
        (train mode) the pair (logits, new running statistics)."""
        params = self.meta.unpack(w_flat, self.post.det)
        stats = self.batch_stats if batch_stats is None else batch_stats
        return self.module(params, stats, *inputs, train=train,
                           batch_mask=batch_mask, mutable=mutable)

    def apply_mean(self, *inputs, train: bool = False):
        """Deterministic forward at the posterior mean."""
        return self.apply_with_weights(self.post.mu, *inputs, train=train)

    def sample_and_apply(self, generator: torch.Generator, *inputs,
                         train: bool = True, mutable: bool = False):
        """One stochastic forward: a weight draw (``bayes.sample_weights``,
        kernel #4 on the card) from ``generator``, then the forward. Not
        differentiable: raises if grad mode is on and the posterior
        requires grad (wrap it in ``torch.no_grad()``)."""
        w = sample_weights(self.post, generator)
        return self.apply_with_weights(w, *inputs, train=train,
                                       mutable=mutable)


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


def unimodal_module(num_classes: int, arch: ArchConfig) -> ResNet50Custom:
    return ResNet50Custom(num_classes, arch.stage_sizes, arch.width,
                          arch.dtype)


def trunk_module(arch: ArchConfig) -> ResNet:
    """A feature trunk (no fc head): (B, feature_size) pooled features."""
    return ResNet(arch.stage_sizes, arch.width, None, arch.dtype)


def _bayesian_bundle(module: nn.Module, params, stats, spec: BNNPriorSpec,
                     dev: torch.device) -> ModelBundle:
    post, meta = bayesianize(params, spec)
    return ModelBundle(module=module, post=post.to(dev), meta=meta,
                       batch_stats=tree_to(stats, dev))


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def make_multimodal_bundle(num_classes: int, spec: BNNPriorSpec,
                           generator: Optional[torch.Generator] = None,
                           arch: ArchConfig = ArchConfig(), *,
                           device: DeviceLike = None) -> ModelBundle:
    """Random-init multimodal bundle, MOPED-bayesianized, on ``device``."""
    dev = resolve_device(device)
    module = multimodal_module(num_classes, arch)
    params, stats = module.init(_generator(generator))
    return _bayesian_bundle(module, params, stats, spec, dev)


def make_unimodal_bundle(input_channels: int, num_classes: int,
                         spec: BNNPriorSpec,
                         generator: Optional[torch.Generator] = None,
                         arch: ArchConfig = ArchConfig(), *,
                         device: DeviceLike = None) -> ModelBundle:
    """Random-init unimodal ``ResNet50Custom`` bundle over
    ``input_channels`` (1 or 3), MOPED-bayesianized, on ``device``."""
    dev = resolve_device(device)
    module = unimodal_module(num_classes, arch)
    params, stats = module.init(_generator(generator), input_channels)
    return _bayesian_bundle(module, params, stats, spec, dev)


def make_feature_trunk(input_channels: int, generator: torch.Generator,
                       arch: ArchConfig, dev: torch.device) -> Dict[str, Any]:
    """A deterministic feature trunk as ``{"module", "variables"}``, as the
    JAX package holds it; ``variables["params"]`` are in the layout the
    module's forward takes (OIHW conv kernels):
    ``module(variables["params"], variables["batch_stats"], x, train=...)``.
    """
    module = trunk_module(arch)
    params, stats = module.init(generator, input_channels)
    return {"module": module,
            "variables": {"params": tree_to(forward_layout(params), dev),
                          "batch_stats": tree_to(stats, dev)}}


_TRUNK_KEYS = (("image", 3), ("channels", 3), ("sss", 1))


def load_models(model_paths: Optional[Dict[str, str]], num_classes: int = 7,
                arch: ArchConfig = ArchConfig(),
                generator: Optional[torch.Generator] = None, *,
                device: DeviceLike = None) -> Tuple[Any, Any, Any]:
    """The reference's three feature trunks ("image", "channels", "sss"),
    as ``{"module", "variables"}`` dicts. A missing path warns and keeps
    the random init, as the JAX package does; a path that exists raises
    (the orbax and bayesian-torch loaders are not ported yet).
    ``num_classes`` is accepted for the reference's signature and unused,
    as in the JAX package (the trunks have no head)."""
    dev = resolve_device(device)
    seeds = torch.randint(0, 2 ** 62, (3,), generator=_generator(generator))
    out = []
    for (name, channels), seed in zip(_TRUNK_KEYS, seeds.tolist()):
        path = (model_paths or {}).get(name)
        if path and os.path.exists(path):
            raise not_ported(f"loading the {name} trunk from {path!r}",
                             "9 (interop: orbax and bayesian-torch loaders)")
        logger.warning("Path not found for model: %s -> %s", name, path)
        out.append(make_feature_trunk(
            channels, torch.Generator().manual_seed(seed), arch, dev))
    return tuple(out)


def move_models_to_device(models: Dict[str, Any], devices=None,
                          use_multigpu_for_multimodal: bool = True, *,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Every bundle's posterior and statistics and every trunk's variables
    on ``device`` (the card by default); the reference's ``devices`` and
    ``use_multigpu_for_multimodal`` are accepted and unused (one device).
    Returns the dict, updated in place."""
    dev = resolve_device(device)
    for m in models.values():
        if isinstance(m, ModelBundle):
            m.post = m.post.to(dev)
            m.batch_stats = tree_to(m.batch_stats, dev)
        elif isinstance(m, dict) and "variables" in m:
            m["variables"] = tree_to(m["variables"], dev)
    return models


def define_models(num_classes: int, const_bnn_prior_parameters,
                  generator: Optional[torch.Generator] = None,
                  arch: ArchConfig = ArchConfig(),
                  pretrained_paths: Optional[Dict[str, str]] = None, *,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """The seven-entry model dict with the reference's keys: three Bayesian
    unimodal classifiers (image and bathy 3-channel, sss 1-channel), the
    Bayesian multimodal model, and three deterministic feature trunks
    (``{"module", "variables"}``). Each model takes its own generator,
    seeded from ``generator`` (the counterpart of the JAX package's
    ``jax.random.split(rng, 7)``). ``pretrained_paths`` (MOPED init from
    torchvision trunks) is not ported yet and raises."""
    if pretrained_paths:
        raise not_ported("pretrained_paths",
                         "9 (interop: init_trunks_from_torchvision)")
    spec = (BNNPriorSpec.from_dict(const_bnn_prior_parameters)
            if isinstance(const_bnn_prior_parameters, dict)
            else const_bnn_prior_parameters)
    dev = resolve_device(device)
    gens = [torch.Generator().manual_seed(s) for s in torch.randint(
        0, 2 ** 62, (7,), generator=_generator(generator)).tolist()]
    uni = lambda c, g: make_unimodal_bundle(c, num_classes, spec, g, arch,
                                            device=dev)
    return {
        "image_model": uni(3, gens[0]),
        "bathy_model": uni(3, gens[1]),
        "sss_model": uni(1, gens[2]),
        "multimodal_model": make_multimodal_bundle(num_classes, spec, gens[3],
                                                   arch, device=dev),
        "image_model_feat": make_feature_trunk(3, gens[4], arch, dev),
        "bathy_model_feat": make_feature_trunk(3, gens[5], arch, dev),
        "sss_model_feat": make_feature_trunk(1, gens[6], arch, dev),
    }
