"""The system under test, built from the benchmark's inputs.

Only here and in ``cells.py`` does the benchmark import the program
(``multimodal_auv_torch``): its module and its packing of the parameter
tree (``build_meta``), into which the benchmark's posterior and BatchNorm
values are put as they are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}


def arch(cfg: Dict):
    from multimodal_auv_torch.models.model_utils import ArchConfig

    return ArchConfig(stage_sizes=tuple(cfg["stage_sizes"]),
                      width=cfg["width"], image_size=cfg["image_size"],
                      dtype=DTYPES[cfg["activation_dtype"]])


def _fill(tree, values: Dict, path=()):
    """A copy of a nested dict whose leaves are ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _fill(v, values, path + (k,)) for k, v in tree.items()}
    return values[path]


class _Shape:
    """A leaf that has only a shape: what ``build_meta`` reads."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _tree(lay) -> Tuple[Dict, Dict]:
    """(parameter tree of shapes, statistics tree of paths) with the
    names and shapes of the benchmark's layout."""
    params: Dict = {}
    for e in lay.entries:
        _set(params, e.path, _Shape(e.shape))
    stats: Dict = {}
    for path in lay.bn_paths:
        for leaf in ("scale", "bias"):
            _set(params, path + (leaf,), _Shape(()))
        for leaf in ("mean", "var"):
            _set(stats, path + (leaf,), path + (leaf,))
    return params, stats


def _set(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def bundle(cfg: Dict, lay, mu, rho, bn: Dict, stats: Dict):
    """A ``ModelBundle`` over ``mu`` and ``rho`` (used as they are) with
    the BatchNorm affine leaves ``bn`` and running statistics ``stats``.
    The program packs the layout's tree itself (``build_meta``), and its
    module reads the leaves by name: a layout that differs from the
    program's fails there or in the comparison."""
    from multimodal_auv_torch.bayes.packing import (
        PackedPosterior,
        build_meta,
        deterministic_part,
    )
    from multimodal_auv_torch.models.model_utils import (
        ModelBundle,
        multimodal_module,
        unimodal_module,
    )

    a = arch(cfg)
    module = (unimodal_module if cfg["model"] == "unimodal"
              else multimodal_module)(cfg["num_classes"], a)
    params, stat_tree = _tree(lay)
    meta = build_meta(params)
    if meta.n_padded != lay.n_padded or meta.n_real != lay.n_real:
        raise RuntimeError(f"the program packs {meta.n_real} / "
                           f"{meta.n_padded} elements, the benchmark's "
                           f"layout {lay.n_real} / {lay.n_padded}")
    det = _fill(deterministic_part(params, meta), bn)
    flat_stats = {}
    for path, (m, v) in stats.items():
        flat_stats[path + ("mean",)] = m
        flat_stats[path + ("var",)] = v
    return ModelBundle(module=module, post=PackedPosterior(mu, rho, det),
                       meta=meta, batch_stats=_fill(stat_tree, flat_stats))


def leaves(tree, path=()):
    """{path: tensor} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, path + (k,)))
        return out
    return {path: tree}


def launches() -> Dict[str, int]:
    from multimodal_auv_torch.ops import kernels

    return dict(kernels.LAUNCHES)
