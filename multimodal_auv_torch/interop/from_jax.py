"""Carry a JAX-package model bundle's weights into the port.

The caller hands over the JAX bundle's arrays as numpy — ``post.mu``,
``post.rho``, the ``det`` and ``batch_stats`` trees — and its ``PackMeta``
entries as plain ``(path, shape, offset, size)`` tuples; nothing of JAX
crosses. Both packages pack in the same layout, so the flat vectors drop
in unchanged once the entries are checked equal to the port's own.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, build_meta
from multimodal_auv_torch.device import DeviceLike, resolve_device
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    ModelBundle,
    multimodal_module,
)

EntryTuple = Tuple[Tuple[str, ...], Tuple[int, ...], int, int]


def _tree_from_numpy(tree, device) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def from_jax(mu: np.ndarray, rho: np.ndarray, det: Dict[str, Any],
             batch_stats: Dict[str, Any], entries: Iterable[EntryTuple], *,
             num_classes: int, arch: ArchConfig = ArchConfig(),
             device: DeviceLike = None) -> ModelBundle:
    """The port's multimodal ``ModelBundle`` holding a JAX bundle's weights.

    Raises ValueError if the JAX entries (paths, HWIO shapes, offsets,
    sizes) or the packed length differ from the port's layout for
    ``num_classes`` and ``arch``."""
    dev = resolve_device(device)
    module = multimodal_module(num_classes, arch)
    params, _ = module.init(torch.Generator().manual_seed(0))
    meta = build_meta(params)
    theirs = tuple((tuple(p), tuple(int(s) for s in shape), int(o), int(n))
                   for p, shape, o, n in entries)
    ours = tuple((e.path, e.shape, e.offset, e.size) for e in meta.entries)
    if theirs != ours:
        diff = next((i for i, (a, b) in enumerate(zip(theirs, ours))
                     if a != b), min(len(theirs), len(ours)))
        raise ValueError(
            f"packing layouts differ at entry {diff}: JAX "
            f"{theirs[diff] if diff < len(theirs) else None} vs port "
            f"{ours[diff] if diff < len(ours) else None}")
    if mu.shape != (meta.n_padded,) or rho.shape != (meta.n_padded,):
        raise ValueError(f"flat posterior of {mu.shape}/{rho.shape}, port "
                         f"expects ({meta.n_padded},)")
    post = PackedPosterior(
        mu=torch.from_numpy(np.array(mu, np.float32)).to(dev),
        rho=torch.from_numpy(np.array(rho, np.float32)).to(dev),
        det=_tree_from_numpy(det, dev))
    return ModelBundle(module=module, post=post, meta=meta,
                       batch_stats=_tree_from_numpy(batch_stats, dev))
