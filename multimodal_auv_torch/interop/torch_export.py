"""Export a packed posterior as a bayesian-torch state dict (port of
``multimodal_auv_tpu/interop/torch_export.py``), the inverse of
``interop/torch_import.py``:

    conv:    {path}.mu_kernel / {path}.rho_kernel   (OIHW)
    linear:  {path}.mu_weight / {path}.rho_weight   ((out, in))
    bias:    {path}.mu_bias   / {path}.rho_bias
    BN:      {path}.weight / {path}.bias / {path}.running_mean /
             {path}.running_var / {path}.num_batches_tracked

``import_posterior(bundle, export_posterior(bundle))`` gives back mu, rho,
``det`` and ``batch_stats`` exactly, and a file written by either package
imports in the other.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from multimodal_auv_torch.interop.hf_manifest import (
    TRUNKS,
    buffer_keys,
    flax_to_torch_mods,
    layers_of,
    walk,
)

logger = logging.getLogger(__name__)


def _to_torch_array(arr: np.ndarray) -> np.ndarray:
    """Inverse of torch_import._to_flax_array."""
    if arr.ndim == 4:  # HWIO -> OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:  # (in, out) -> (out, in)
        return np.transpose(arr, (1, 0))
    return arr


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def export_posterior(bundle) -> Dict[str, np.ndarray]:
    """A bayesian-torch-named state dict (f32 numpy values) of a bundle's
    posterior and running statistics."""
    meta, post = bundle.meta, bundle.post
    mu, rho = _host(post.mu), _host(post.rho)
    sd: Dict[str, np.ndarray] = {}
    for e in meta.entries:
        base = ".".join(flax_to_torch_mods(e.path[:-1]))
        # 4-D conv kernels are bayesian-torch's *_kernel, 2-D dense
        # matrices its *_weight
        suffix = ("bias" if e.path[-1] != "kernel"
                  else "kernel" if len(e.shape) == 4 else "weight")
        for name, flat in (("mu", mu), ("rho", rho)):
            sd[f"{base}.{name}_{suffix}"] = _to_torch_array(
                flat[e.offset:e.offset + e.size].reshape(e.shape))
    for path, val in walk(post.det):
        base = ".".join(flax_to_torch_mods(path[:-1]))
        name = {"scale": "weight", "bias": "bias"}.get(path[-1])
        if name is None:
            logger.warning("Unmapped deterministic leaf %s.%s", base, path[-1])
            continue
        sd[f"{base}.{name}"] = _host(val)
    for path, val in walk(bundle.batch_stats):
        base = ".".join(flax_to_torch_mods(path[:-1]))
        name = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if name is None:
            logger.warning("Unmapped batch stat %s.%s", base, path[-1])
            continue
        sd[f"{base}.{name}"] = _host(val)
        # torch BN tracks this; 0 satisfies strict loaders
        sd.setdefault(f"{base}.num_batches_tracked", np.zeros((), np.int64))
    return sd


def _published(sd: Dict[str, np.ndarray], meta) -> Dict[str, np.ndarray]:
    """The artifact's form of an exported dict: trunk keys nested under
    ``.model.``, a ``module.`` prefix, and every variational layer's
    bayesian-torch eps / prior buffers, zero-filled."""
    out = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        out[f"module.{head}.model.{rest}" if head in TRUNKS
            else f"module.{k}"] = v
    for mod_path, leaves in layers_of(meta).items():
        for k, shape in buffer_keys(mod_path, leaves, published=True).items():
            out[f"module.{k}"] = np.zeros(shape, np.float32)
    return out


def save_torch_checkpoint(bundle, path: str, *,
                          published: bool = False) -> Dict[str, int]:
    """``torch.save`` the exported state dict (CPU tensors) at ``path``,
    loadable by the reference's loaders and by both packages' importers.
    ``published`` writes the form of the published HF checkpoint (see
    ``_published``), which the importers strip and ignore."""
    sd = export_posterior(bundle)
    if published:
        sd = _published(sd, bundle.meta)
    # copies: a view would share memory with the bundle's tensors
    torch.save({k: torch.from_numpy(np.array(v, order="C"))
                for k, v in sd.items()}, path)
    logger.info("Exported %d tensors to %s", len(sd), path)
    return {"exported": len(sd)}
