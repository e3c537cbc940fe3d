"""bayesian-torch checkpoint import (port of
``multimodal_auv_tpu/interop/torch_import.py``).

The reference downloads ``sams-tom/multimodal-auv-bathy-bnn-classifier /
multimodal-bnn/pytorch_model.bin``, a bayesian-torch ``dnn_to_bnn`` state
dict, and loads it with key remapping: strip a ``module.`` prefix, remap
``{image,bathy,sss}_model_feat.model.`` -> ``*_model_feat.``, drop the
``fc2.*`` head when the class count differs (the foundation-model head
swap), and tolerate what does not fit (``strict=False``).

The port keeps the JAX package's packed layout, so the keys map onto the
same paths:

  torch (bayesian-torch)                 packed posterior
  -------------------------------------  --------------------------------
  conv ``mu_kernel`` / ``rho_kernel``    ``kernel`` (OIHW -> HWIO)
  linear ``mu_weight`` / ``rho_weight``  ``kernel`` ((out, in) -> (in, out))
  linear ``mu_bias`` / ``rho_bias``      ``bias``
  BN ``weight`` / ``bias``               ``det``: ``scale`` / ``bias``
  BN ``running_mean`` / ``running_var``  ``batch_stats``: ``mean`` / ``var``
  ``layerL.B.``                          ``layerL_B``
  ``downsample.0`` / ``downsample.1``    ``downsample_conv`` / ``downsample_bn``

Deterministic (torchvision-style) dicts with plain ``weight`` / ``bias``
set mu, and rho is re-derived by MOPED. The arithmetic is the JAX
package's, in numpy on the host; the result moves to the bundle's device
once, so imported leaves equal the JAX package's bit for bit.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.interop.hf_manifest import (
    TRUNKS,
    audit_coverage,
    expected_checkpoint_keys,
    log_coverage,
)

logger = logging.getLogger(__name__)

_LAYER_RE = re.compile(r"^layer(\d+)\.(\d+)$")


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's state dict as numpy on the host: ``module.``
    stripped, ``*_model_feat.model.`` remapped to ``*_model_feat.``. Tries
    ``weights_only=True`` first (hub files are third-party pickles); a
    whole-module save falls back to full unpickling, with a warning."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        logger.warning(
            "%s is not a plain-tensor checkpoint; falling back to full "
            "unpickling (legacy whole-module save). Only do this for "
            "checkpoints you trust.", path)
        raw = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    out = {}
    for k, v in raw.items():
        if k.startswith("module."):
            k = k[len("module."):]
        for mod in ("image", "bathy", "sss"):
            k = k.replace(f"{mod}_model_feat.model.", f"{mod}_model_feat.")
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                            else v)
    return out


def _segments_to_flax(segments) -> Tuple[str, ...]:
    """torch module path segments -> packed-layout module names."""
    out = []
    i = 0
    while i < len(segments):
        s = segments[i]
        m = (_LAYER_RE.match(s + "." + segments[i + 1])
             if i + 1 < len(segments) else None)
        if m:
            out.append(f"layer{m.group(1)}_{m.group(2)}")
            i += 2
            continue
        if s == "downsample" and i + 1 < len(segments):
            out.append("downsample_conv" if segments[i + 1] == "0"
                       else "downsample_bn")
            i += 2
            continue
        out.append(s)
        i += 1
    return tuple(out)


def torch_key_to_flax(key: str) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """(module path, leaf name, kind) of a torch state-dict key, kind in
    {mu, rho, det, bn_mean, bn_var}; None for keys the import ignores
    (num_batches_tracked, the eps and prior buffers)."""
    parts = key.split(".")
    leaf = parts[-1]
    mods = _segments_to_flax(parts[:-1])
    if leaf in ("mu_kernel", "mu_weight"):
        return mods, "kernel", "mu"
    if leaf in ("rho_kernel", "rho_weight"):
        return mods, "kernel", "rho"
    if leaf == "mu_bias":
        return mods, "bias", "mu"
    if leaf == "rho_bias":
        return mods, "bias", "rho"
    if leaf == "running_mean":
        return mods, "mean", "bn_mean"
    if leaf == "running_var":
        return mods, "var", "bn_var"
    if leaf == "num_batches_tracked" or leaf.startswith("prior_"):
        return None
    if leaf == "weight":
        # BatchNorm scale or a deterministic conv / linear weight: the
        # rank tells them apart
        return mods, "weight", "det"
    if leaf == "bias":
        return mods, "bias", "det"
    return None


def _to_flax_array(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # conv OIHW -> HWIO
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 2:  # linear (out, in) -> (in, out)
        return np.transpose(arr, (1, 0))
    return arr


def _get(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _host_tree(tree):
    """A nested dict of tensors as a fresh nested dict of host numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _device_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _device_tree(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def import_posterior(
    bundle,
    state_dict: Dict[str, np.ndarray],
    *,
    num_classes: Optional[int] = None,
    pretrained_head_classes: int = 7,
    spec: Optional[BNNPriorSpec] = None,
) -> Tuple[PackedPosterior, Dict[str, Any], Dict[str, Any]]:
    """Merge a torch state dict into a bundle's posterior and statistics.

    Returns (new post, new batch_stats, stats), on the bundle's device;
    the bundle is not changed. Unknown keys and shape mismatches are
    dropped (``strict=False``); ``fc2.*`` is dropped when ``num_classes``
    differs from ``pretrained_head_classes``. ``stats`` counts loaded,
    dropped and ignored keys, and carries the by-name audit against the
    expected inventory (``interop/hf_manifest.py``): ``missing`` loadable
    keys and ``unexpected`` ones."""
    spec = spec or BNNPriorSpec()
    meta, post = bundle.meta, bundle.post
    dev = post.mu.device
    drop_head = num_classes is not None and num_classes != pretrained_head_classes

    mu_tree: Dict = {}
    rho_tree: Dict = {}
    det = _host_tree(post.det)
    bs = _host_tree(bundle.batch_stats)
    var_paths = {e.path: e for e in meta.entries}
    stats = {"loaded": 0, "dropped": 0, "ignored": 0}

    for key, arr in state_dict.items():
        mapped = torch_key_to_flax(key)
        if mapped is None:
            stats["ignored"] += 1
            continue
        mods, leaf, kind = mapped
        if drop_head and mods and mods[0] == "fc2":
            stats["dropped"] += 1
            logger.info("Dropping pretrained head key %s (num_classes "
                        "mismatch)", key)
            continue

        if kind in ("mu", "rho"):
            path = mods + (leaf,)
            e = var_paths.get(path)
            val = _to_flax_array(arr)
            if e is None or tuple(val.shape) != e.shape:
                stats["dropped"] += 1
                logger.warning("Dropping %s (no variational match at %s)",
                               key, path)
                continue
            _set(mu_tree if kind == "mu" else rho_tree, path, val)
            stats["loaded"] += 1
        elif kind == "det":
            if arr.ndim == 1:
                if leaf == "weight":  # BatchNorm weight -> scale
                    path = mods + ("scale",)
                    cur = _get(det, path)
                    if cur is not None and arr.shape == np.shape(cur):
                        _set(det, path, arr)
                        stats["loaded"] += 1
                    else:
                        stats["dropped"] += 1
                else:
                    # a BatchNorm bias (deterministic) or a plain conv /
                    # linear bias (variational mu under MOPED)
                    path = mods + ("bias",)
                    cur = _get(det, path)
                    e = var_paths.get(path)
                    if cur is not None and arr.shape == np.shape(cur):
                        _set(det, path, arr)
                        stats["loaded"] += 1
                    elif e is not None and tuple(arr.shape) == e.shape:
                        _set(mu_tree, path, arr)
                        stats["loaded"] += 1
                    else:
                        stats["dropped"] += 1
            else:
                # a deterministic conv / linear weight -> mu (MOPED init)
                path = mods + ("kernel",)
                e = var_paths.get(path)
                val = _to_flax_array(arr)
                if e is not None and tuple(val.shape) == e.shape:
                    _set(mu_tree, path, val)
                    stats["loaded"] += 1
                else:
                    stats["dropped"] += 1
                    logger.warning("Dropping %s (no match at %s)", key, path)
        elif kind in ("bn_mean", "bn_var"):
            path = mods + ({"bn_mean": "mean", "bn_var": "var"}[kind],)
            cur = _get(bs, path)
            if cur is not None and arr.shape == np.shape(cur):
                _set(bs, path, arr)
                stats["loaded"] += 1
            else:
                stats["dropped"] += 1

    # fold the loaded leaves into the packed vectors
    mu = post.mu.detach().cpu().numpy().copy()
    rho = post.rho.detach().cpu().numpy().copy()
    for e in meta.entries:
        mv = _get(mu_tree, e.path)
        rv = _get(rho_tree, e.path)
        if mv is not None:
            mu[e.offset:e.offset + e.size] = np.ravel(mv)
            if rv is None:
                # deterministic import: MOPED re-derivation of sigma
                sigma = np.maximum(spec.moped_delta * np.abs(np.ravel(mv)),
                                   1e-12)
                rho[e.offset:e.offset + e.size] = np.log(np.expm1(sigma))
        if rv is not None:
            rho[e.offset:e.offset + e.size] = np.ravel(rv)

    new_post = PackedPosterior(mu=torch.from_numpy(mu).to(dev),
                               rho=torch.from_numpy(rho).to(dev),
                               det=_device_tree(det, dev))
    new_bs = _device_tree(bs, dev)
    logger.info("Torch import: %(loaded)d loaded, %(dropped)d dropped, "
                "%(ignored)d ignored", stats)
    try:
        # by-name coverage against the inventory (post-remap form; fc2.*
        # is legitimately absent under a head swap)
        expected = expected_checkpoint_keys(bundle, published=False,
                                            include_buffers=True)
        if drop_head:
            expected = {k: v for k, v in expected.items()
                        if not k.startswith("fc2.")}
        audit = audit_coverage(state_dict, expected)
        stats["missing"] = audit["missing"]
        stats["unexpected"] = audit["unexpected"]
        log_coverage(audit, name="torch import")
    except Exception as e:  # the audit must never break an import
        logger.warning("Import coverage audit unavailable: %s", e)
    return new_post, new_bs, stats


def rekey(state_dict: Dict[str, np.ndarray], prefix: str
          ) -> Dict[str, np.ndarray]:
    """A trunk's state dict under the module prefix ``prefix`` ("" for
    none)."""
    pref = f"{prefix}." if prefix else ""
    return {f"{pref}{k}": v for k, v in state_dict.items()}


def init_trunks_from_torchvision(
    bundle,
    state_dict: Dict[str, np.ndarray],
    prefixes: Tuple[str, ...] = TRUNKS,
    *,
    spec: Optional[BNNPriorSpec] = None,
) -> Tuple[PackedPosterior, Dict[str, Any], Dict[str, Any]]:
    """MOPED-initialise ResNet trunks from a torchvision-named ResNet-50
    state dict (``conv1.weight``, ``layer1.0.conv1.weight``, ``fc.weight``:
    the IMAGENET1K_V1 format the reference feeds to ``dnn_to_bnn``).

    The dict is re-keyed under each trunk prefix and merged: weights become
    mu with sigma = delta * |w|, BatchNorm affine and statistics load
    directly, and keys with no geometric match (the 1000-class ``fc.*``;
    ``conv1`` for the 1-channel SSS trunk) are dropped, as the reference
    replaces fc by Identity and gives the SSS trunk a fresh conv1."""
    merged = {}
    for p in prefixes:
        merged.update(rekey(state_dict, p))
    return import_posterior(bundle, merged, spec=spec)


def load_and_prepare_multimodal_model(bundle, weights_path: str,
                                      num_classes: int = 7):
    """The reference's load_and_prepare_multimodal_model: the checkpoint
    at ``weights_path`` imported into ``bundle`` (changed in place).
    Returns (bundle, stats)."""
    sd = load_torch_state_dict(weights_path)
    post, bs, stats = import_posterior(bundle, sd, num_classes=num_classes)
    bundle.post = post
    bundle.batch_stats = bs
    return bundle, stats
