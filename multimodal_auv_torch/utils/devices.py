"""Device / environment utilities (port of
``multimodal_auv_tpu/utils/devices.py``).

The reference's ``setup_environment_and_devices`` picked CUDA GPUs via a
pynvml memory probe and wrapped models in nn.DataParallel; the port
enumerates torch devices and places work by ``device.py::resolve_device``
(one process per card under a process group, ``parallel/``). The JAX
package's ``enable_compilation_cache`` configures XLA's persistent
compilation cache, which has no PyTorch counterpart here: the port runs
eagerly and builds its kernels once per source hash
(``ops/kernels.py``), so it is not ported (ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def get_available_devices(platform: str = "cuda") -> List[torch.device]:
    """The visible devices of ``platform``: every card for "cuda" (none
    without one: no fallback to the CPU), the one CPU device for "cpu"."""
    if platform == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    if platform == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")


def setup_environment_and_devices(
    root_dir: Optional[str] = None, platform: str = "cuda",
) -> Tuple[str, List[torch.device]]:
    """Parity shim for the reference's config/paths.py:96: resolves the
    working directory (env var MULTIMODAL_AUV_ROOT > argument > cwd; no
    interactive input()) and returns (root_dir, devices of ``platform``)."""
    root = os.environ.get("MULTIMODAL_AUV_ROOT") or root_dir or os.getcwd()
    devices = get_available_devices(platform)
    logger.info("Using root_dir=%s, %d %s device(s)", root, len(devices),
                platform)
    return root, devices


def _tensor_leaves(tree, path: str = ""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensor_leaves(getattr(tree, f.name),
                                      f"{path}.{f.name}")


def check_model_devices(tree) -> Dict[str, torch.device]:
    """Log the device of every tensor of ``tree`` (an ``nn.Module``'s
    parameters and buffers, or a nested dict / list / tuple / dataclass of
    tensors such as a ``PackedPosterior``), the reference's
    utils/device.py:57; returns {path: device}."""
    if isinstance(tree, torch.nn.Module):
        leaves = list(tree.named_parameters()) + list(tree.named_buffers())
    else:
        leaves = list(_tensor_leaves(tree))
    out = {}
    for path, leaf in leaves:
        logger.info("%s -> %s", path, leaf.device)
        out[path] = leaf.device
    return out
