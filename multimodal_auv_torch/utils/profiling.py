"""Profiling — ``torch.profiler`` traces viewable in Perfetto or
TensorBoard (port of ``multimodal_auv_tpu/utils/profiling.py``, which
traces with ``jax.profiler``).

The reference's only observability is TB scalars; this adds device traces
for kernel-level performance work.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from multimodal_auv_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str = "profile_traces", device: DeviceLike = None):
    """Context manager: ``with trace('dir'): step(...)`` records the host
    ops and, when ``device`` is a card (None: the card, raising without
    one), its kernels, and on exit writes one Chrome trace
    ``<log_dir>/trace_<pid>_<ns>.pt.trace.json`` (open in Perfetto, or in
    TensorBoard's profile plugin). Yields ``log_dir``, as the JAX
    package's does."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)
