"""Carry a JAX-package model bundle's weights into the port.

The caller hands over the JAX bundle's arrays as numpy — ``post.mu``,
``post.rho``, the ``det`` and ``batch_stats`` trees — and its ``PackMeta``
entries as plain ``(path, shape, offset, size)`` tuples; nothing of JAX
crosses. Both packages pack in the same layout, so the flat vectors drop
in unchanged once the entries are checked equal to the port's own.

``kind`` names the module: ``"multimodal"`` or ``("unimodal", channels)``.
A deterministic feature trunk (``define_models``' ``*_feat`` entries) goes
across as its plain flax variables (``trunk_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple, Union

import numpy as np
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, build_meta
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    ModelBundle,
    multimodal_module,
    trunk_module,
    unimodal_module,
)
from multimodal_auv_torch.models.resnet import forward_layout

EntryTuple = Tuple[Tuple[str, ...], Tuple[int, ...], int, int]
Kind = Union[str, Tuple[str, int]]


def _tree_from_numpy(tree, device) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _first_difference(theirs, ours, what: str) -> None:
    if theirs != ours:
        diff = next((i for i, (a, b) in enumerate(zip(theirs, ours))
                     if a != b), min(len(theirs), len(ours)))
        raise ValueError(
            f"{what} differ at entry {diff}: JAX "
            f"{theirs[diff] if diff < len(theirs) else None} vs port "
            f"{ours[diff] if diff < len(ours) else None}")


def _module_and_params(kind: Kind, num_classes: int, arch: ArchConfig):
    gen = torch.Generator().manual_seed(0)
    if kind == "multimodal":
        module = multimodal_module(num_classes, arch)
        return module, module.init(gen)[0]
    if isinstance(kind, tuple) and kind[0] == "unimodal" and kind[1] in (1, 3):
        module = unimodal_module(num_classes, arch)
        return module, module.init(gen, kind[1])[0]
    raise ValueError(f"unknown module kind {kind!r}: 'multimodal' or "
                     f"('unimodal', 1 or 3)")


def from_jax(mu: np.ndarray, rho: np.ndarray, det: Dict[str, Any],
             batch_stats: Dict[str, Any], entries: Iterable[EntryTuple], *,
             num_classes: int, arch: ArchConfig = ArchConfig(),
             kind: Kind = "multimodal",
             device: DeviceLike = None) -> ModelBundle:
    """The port's ``ModelBundle`` of ``kind`` holding a JAX bundle's weights.

    Raises ValueError if the JAX entries (paths, HWIO shapes, offsets,
    sizes) or the packed length differ from the port's layout for
    ``kind``, ``num_classes`` and ``arch``."""
    dev = resolve_device(device)
    module, params = _module_and_params(kind, num_classes, arch)
    meta = build_meta(params)
    theirs = tuple((tuple(p), tuple(int(s) for s in shape), int(o), int(n))
                   for p, shape, o, n in entries)
    ours = tuple((e.path, e.shape, e.offset, e.size) for e in meta.entries)
    _first_difference(theirs, ours, "packing layouts")
    if mu.shape != (meta.n_padded,) or rho.shape != (meta.n_padded,):
        raise ValueError(f"flat posterior of {mu.shape}/{rho.shape}, port "
                         f"expects ({meta.n_padded},)")
    post = PackedPosterior(
        mu=torch.from_numpy(np.array(mu, np.float32)).to(dev),
        rho=torch.from_numpy(np.array(rho, np.float32)).to(dev),
        det=_tree_from_numpy(det, dev))
    return ModelBundle(module=module, post=post, meta=meta,
                       batch_stats=_tree_from_numpy(batch_stats, dev))


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], path + (k,))
    else:
        yield path, tuple(int(s) for s in np.shape(tree))


def trunk_from_jax(variables: Dict[str, Any], *, input_channels: int,
                   arch: ArchConfig = ArchConfig(),
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The port's feature trunk ``{"module", "variables"}`` holding a JAX
    trunk's flax variables (``{"params", "batch_stats"}`` as numpy). Raises
    ValueError if the parameter paths or shapes (HWIO) differ from the
    port's."""
    dev = resolve_device(device)
    module = trunk_module(arch)
    params, _ = module.init(torch.Generator().manual_seed(0), input_channels)
    _first_difference(tuple(_shapes(variables["params"])),
                      tuple(_shapes(params)), "trunk parameters")
    return {"module": module, "variables": {
        "params": forward_layout(_tree_from_numpy(variables["params"], dev)),
        "batch_stats": _tree_from_numpy(variables["batch_stats"], dev)}}
