"""Profiling — ``torch.profiler`` traces viewable in Perfetto or
TensorBoard (port of ``multimodal_auv_tpu/utils/profiling.py``, which
traces with ``jax.profiler``), and the program's named spans.

The reference's only observability is TB scalars; this adds device traces
for kernel-level performance work.

``span(name)`` marks a stretch of the program (``with span("auv.bn"):``).
Off, which is the default, it is a flag check and a shared null context:
nothing allocated, no tensor held, no sync. Under a recording
``torch.profiler`` it is a ``record_function``, so its event sits in the
same Chrome trace as the kernels it launched, on the same clock
(``trace`` below shows it). Inside ``collect()`` it also adds its count and
host duration to the table ``collect`` yields. Spans never enter a traced
graph: under ``torch.compile``, ``torch.export`` or a higher-order op's
tracing they are null. The program's spans:

* ``auv.step``: the body of a predict step (packed, plain, mesh,
  unimodal) or of the train step;
* ``auv.sample``: a chunk's sampler call (``engine/mc.py``);
* ``auv.conv``, ``auv.bn``: one convolution with its casts, one BatchNorm
  (``models/resnet.py``, ``models/fused.py``);
* ``auv.backward``: the train step's ``loss.backward()``;
* ``auv.guard``: the train step's NaN guard, its one host sync;
* ``auv.place``: a batch's host-to-device copies;
* ``auv.drain``: a batch's outputs copied to the host.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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


_NULL = contextlib.nullcontext()
_TABLES: list = []  # the tables of the open collect() blocks
_LOCK = threading.Lock()


def _tracing() -> bool:
    """True while a graph is being traced: torch.compile, torch.export,
    a higher-order op's body, or any make_fx tracing."""
    return (torch.compiler.is_compiling()
            or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.PROXY) is not None)


class _Span:
    __slots__ = ("name", "record", "tables", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = None
        if _autograd_profiler._is_profiler_enabled:
            self.record = _autograd_profiler.record_function(self.name)
            self.record.__enter__()
        self.tables = tuple(_TABLES)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.tables:
            with _LOCK:
                for table in self.tables:
                    count, seconds = table.get(self.name, (0, 0.0))
                    table[self.name] = (count + 1, seconds + dt * 1e-9)
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking ``name``: null unless a profiler records
    or ``collect()`` is open, and always null while a graph is traced."""
    if not (_TABLES or _autograd_profiler._is_profiler_enabled):
        return _NULL
    if _tracing():
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, Tuple[int, float]]]:
    """``with collect() as table:`` counts every span entered inside the
    block, on any thread, with its host ``perf_counter`` duration:
    ``table[name]`` is (count, seconds). With or without a profiler."""
    table: Dict[str, Tuple[int, float]] = {}
    with _LOCK:
        _TABLES.append(table)
    try:
        yield table
    finally:
        with _LOCK:
            del _TABLES[next(i for i, t in enumerate(_TABLES)
                             if t is table)]
