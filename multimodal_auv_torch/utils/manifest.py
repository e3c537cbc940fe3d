"""Run manifests: record what actually ran, next to its outputs (port of
``multimodal_auv_tpu/utils/manifest.py``).

Each training pipeline drops a ``run_manifest.json`` next to its CSV
ledgers: the full argument set (JSON-safe, with the RNG seed), package and
library versions, device kind/count, and hostname/time — enough to re-run
the exact experiment or explain a regression. Written best-effort: a
manifest failure must never kill a training run.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import sys
import time
from typing import Any, Dict

logger = logging.getLogger(__name__)


def _json_safe(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if hasattr(v, "to_dict"):
        try:
            return _json_safe(v.to_dict())
        except Exception:
            pass
    return repr(v)


def write_run_manifest(out_dir: str, kind: str, config: Dict[str, Any],
                       device=None) -> str | None:
    """Write ``{out_dir}/run_manifest.json``. ``device``: the torch device
    the run uses. Returns the path, or None on any failure (logged, never
    raised)."""
    try:
        import torch

        import multimodal_auv_torch

        dev = torch.device(device if device is not None else "cpu")
        on_card = dev.type == "cuda"
        manifest = {
            "kind": kind,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "hostname": socket.gethostname(),
            "argv": list(sys.argv),
            "config": _json_safe(config),
            "versions": {
                "multimodal_auv_torch": getattr(multimodal_auv_torch,
                                                "__version__", "unknown"),
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "python": sys.version.split()[0],
            },
            "devices": {
                "count": torch.cuda.device_count() if on_card else 1,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "platform": dev.type,
            },
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "run_manifest.json")
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)
        logger.info("Run manifest written to %s", path)
        return path
    except Exception as e:  # never let provenance kill the run
        logger.warning("Could not write run manifest: %s", e)
        return None
