"""Model construction (port of ``multimodal_auv_tpu/models/model_utils.py``):
``ModelBundle``, ``ArchConfig``, the bundle makers, and ``define_models``,
``load_models`` and ``move_models_to_device``.

Weights are initialised on the CPU from a ``torch.Generator`` and then moved
to the device, so one seed gives the same bundle on the CPU and the card.
Without pretrained weights the trunks are random; MOPED then sets
sigma = moped_delta * |w|, and without MOPED the posterior is drawn from
the same generator (``bayes.packing.bayesianize``). ``define_models(pretrained_paths=...)`` and
``load_models`` read torch state dicts (torchvision-named trunks, or
bayesian-torch files) through ``interop/torch_import.py``; the JAX
package's orbax checkpoint directories are not readable here.
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
                     dev: torch.device,
                     generator: torch.Generator) -> ModelBundle:
    post, meta = bayesianize(params, spec, generator=generator)
    return ModelBundle(module=module, post=post.to(dev), meta=meta,
                       batch_stats=tree_to(stats, dev))


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def make_multimodal_bundle(num_classes: int, spec: BNNPriorSpec,
                           generator: Optional[torch.Generator] = None,
                           arch: ArchConfig = ArchConfig(), *,
                           device: DeviceLike = None) -> ModelBundle:
    """Random-init multimodal bundle, bayesianized (MOPED, or drawn from
    ``generator`` after the init without it), on ``device``."""
    dev = resolve_device(device)
    module = multimodal_module(num_classes, arch)
    generator = _generator(generator)
    params, stats = module.init(generator)
    return _bayesian_bundle(module, params, stats, spec, dev, generator)


def make_unimodal_bundle(input_channels: int, num_classes: int,
                         spec: BNNPriorSpec,
                         generator: Optional[torch.Generator] = None,
                         arch: ArchConfig = ArchConfig(), *,
                         device: DeviceLike = None) -> ModelBundle:
    """Random-init unimodal ``ResNet50Custom`` bundle over
    ``input_channels`` (1 or 3), bayesianized as the multimodal bundle,
    on ``device``."""
    dev = resolve_device(device)
    module = unimodal_module(num_classes, arch)
    generator = _generator(generator)
    params, stats = module.init(generator, input_channels)
    return _bayesian_bundle(module, params, stats, spec, dev, generator)


def make_feature_trunk(input_channels: int, generator: torch.Generator,
                       arch: ArchConfig, dev: torch.device,
                       state_dict: Optional[Dict[str, Any]] = None,
                       spec: BNNPriorSpec = BNNPriorSpec()) -> Dict[str, Any]:
    """A deterministic feature trunk as ``{"module", "variables"}``, as the
    JAX package holds it; ``variables["params"]`` are in the layout the
    module's forward takes (OIHW conv kernels):
    ``module(variables["params"], variables["batch_stats"], x, train=...)``.

    With ``state_dict`` (a trunk's torch state dict, numpy values), the
    random init is MOPED-bayesianized, the dict imported into it, and the
    posterior mean kept: the keys that match load, the rest keep their
    random values."""
    module = trunk_module(arch)
    params, stats = module.init(generator, input_channels)
    if state_dict is not None:
        from multimodal_auv_torch.interop.torch_import import import_posterior

        post, meta = bayesianize(params, spec)
        post, stats, _ = import_posterior(
            ModelBundle(module, post, meta, stats), state_dict, spec=spec)
        # unpack gives the forward's layout as views into mu: own copies
        params = _owned(meta.unpack(post.mu, post.det))
    else:
        params = forward_layout(params)
    return {"module": module,
            "variables": {"params": tree_to(params, dev),
                          "batch_stats": tree_to(stats, dev)}}


def _owned(tree):
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    return tree.clone(memory_format=torch.contiguous_format)


_TRUNK_KEYS = (("image", 3), ("channels", 3), ("sss", 1))


def load_models(model_paths: Optional[Dict[str, str]], num_classes: int = 7,
                arch: ArchConfig = ArchConfig(),
                generator: Optional[torch.Generator] = None, *,
                device: DeviceLike = None) -> Tuple[Any, Any, Any]:
    """The reference's three feature trunks ("image", "channels", "sss"),
    as ``{"module", "variables"}`` dicts. A path that is a torch file is
    imported into the trunk (``make_feature_trunk``'s ``state_dict``); a
    missing path warns and keeps the random init, as the JAX package does.
    A file that fails to load is logged and keeps the random init, as in
    the JAX package; a directory (an orbax checkpoint of the JAX package,
    which the port cannot read) is such a failure. ``num_classes`` is accepted
    for the reference's signature and unused, as in the JAX package (the
    trunks have no head)."""
    from multimodal_auv_torch.interop.torch_import import load_torch_state_dict

    dev = resolve_device(device)
    seeds = torch.randint(0, 2 ** 62, (3,), generator=_generator(generator))
    out = []
    for (name, channels), seed in zip(_TRUNK_KEYS, seeds.tolist()):
        sd = None
        path = (model_paths or {}).get(name)
        if path and os.path.exists(path):
            try:
                if os.path.isdir(path):
                    raise IsADirectoryError(
                        f"{path} is a directory (an orbax checkpoint of the "
                        "JAX package); the port reads torch files only")
                sd = load_torch_state_dict(path)
                logger.info("%s model loaded successfully from %s",
                            name.capitalize(), path)
            except Exception as e:
                logger.error("Failed to load %s model from %s: %s", name,
                             path, e, exc_info=True)
        else:
            logger.warning("Path not found for model: %s -> %s", name, path)
        out.append(make_feature_trunk(
            channels, torch.Generator().manual_seed(seed), arch, dev, sd))
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
    ``jax.random.split(rng, 7)``).

    ``pretrained_paths``: optional {"image", "channels", "sss"} paths to
    torchvision-named ResNet-50 state dicts (the offline stand-in for the
    reference's IMAGENET1K_V1 download). They MOPED-initialise the trunks
    of the three unimodal bundles, the multimodal bundle and the three
    feature trunks (sigma = delta * |w|); the 1000-class fc head and a
    channel-mismatched conv1 keep their random init, as in the reference's
    fc -> Identity swap. A file that does not load is logged and skipped."""
    from multimodal_auv_torch.interop.torch_import import (
        import_posterior,
        load_torch_state_dict,
        rekey,
    )

    spec = (BNNPriorSpec.from_dict(const_bnn_prior_parameters)
            if isinstance(const_bnn_prior_parameters, dict)
            else const_bnn_prior_parameters)
    dev = resolve_device(device)
    gens = [torch.Generator().manual_seed(s) for s in torch.randint(
        0, 2 ** 62, (7,), generator=_generator(generator)).tolist()]
    sds: Dict[str, Any] = {}
    for name, path in (pretrained_paths or {}).items():
        try:
            sds[name] = load_torch_state_dict(path)
        except Exception:
            logger.warning("Could not load pretrained trunk %s from %s",
                           name, path, exc_info=True)

    def moped_trunks(bundle: ModelBundle, by_prefix: Dict[str, str]):
        """The bundle with its trunks (module prefix -> pretrained_paths
        name) imported from their dicts."""
        merged = {}
        for prefix, name in by_prefix.items():
            if name in sds:
                merged.update(rekey(sds[name], prefix))
        if merged:
            bundle.post, bundle.batch_stats, _ = import_posterior(
                bundle, merged, spec=spec)
        return bundle

    uni = lambda c, g, name: moped_trunks(make_unimodal_bundle(
        c, num_classes, spec, g, arch, device=dev), {"model": name})
    feat = lambda c, g, name: make_feature_trunk(c, g, arch, dev,
                                                 sds.get(name), spec)
    return {
        "image_model": uni(3, gens[0], "image"),
        "bathy_model": uni(3, gens[1], "channels"),
        "sss_model": uni(1, gens[2], "sss"),
        "multimodal_model": moped_trunks(
            make_multimodal_bundle(num_classes, spec, gens[3], arch,
                                   device=dev),
            {"image_model_feat": "image", "bathy_model_feat": "channels",
             "sss_model_feat": "sss"}),
        "image_model_feat": feat(3, gens[4], "image"),
        "bathy_model_feat": feat(3, gens[5], "channels"),
        "sss_model_feat": feat(1, gens[6], "sss"),
    }
