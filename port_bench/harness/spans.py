"""The program's own spans (``multimodal_auv_torch.utils.profiling.span``:
``auv.bn``, ``auv.conv``, ``auv.place``, ``auv.guard``, ``auv.backward``
and the rest), read in two more passes of the cell's ``trace_batches``
through ``loop.traced()``. The first reader that needs a pass runs it,
and the pass is kept on the readings object, so the two run once a run,
after every reader listed before the first of them in ``BENCHMARK.json``.

``device(run)``, the device pass: the batches under ``torch.profiler``
with the host and CUDA activities, reduced (``reduce``) to each span
name's count, the kernels launched inside its spans and their device
microseconds. A kernel belongs to a span when its launch call (the
CUDA API call of the same correlation id) lies inside the span on the
same thread: remat's re-forward runs its ``auv.bn`` spans on
autograd's thread, and its kernels count there. ``auv.backward`` takes
every kernel launched inside its interval on any thread, since the
autograd engine launches from threads of its own.

``host(run)``, the host pass: the batches inside ``collect()`` with no
profiler, so the host runs at its own pace; each span name's count and
host seconds.

A program without the spans (one older than them) gives None for both,
and every reader of them then reads nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PREFIX = "auv."
ANY_THREAD = "auv.backward"
SPAN_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceSpans:
    batches: int
    draws: int
    count: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    device_us: Dict[str, float] = field(default_factory=dict)

    def ms(self, name: str) -> Optional[float]:
        """Device ms of ``name``'s kernels; None where it launched none."""
        if not self.launches.get(name):
            return None
        return self.device_us[name] / 1e3


@dataclass
class HostSpans:
    batches: int
    table: Dict[str, tuple] = field(default_factory=dict)

    def ms(self, name: str) -> Optional[float]:
        """Host ms inside ``name``'s spans; None where none ran."""
        if name not in self.table:
            return None
        return self.table[name][1] * 1e3


def _program():
    """The program's span module, or None where it has no spans."""
    try:
        from multimodal_auv_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "collect") or not hasattr(profiling, "span"):
        return None
    return profiling


def reduce(events: List[Dict]):
    """(count, launches, device_us) per span name of a Chrome trace."""
    spans: Dict = defaultdict(list)   # tid -> (ts, end, name)
    anywhere: List = []               # (ts, end) of the any-thread spans
    launches: Dict = defaultdict(list)  # tid -> (ts, corr)
    kernel_us: Dict[int, float] = {}
    count: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), str(e.get("name", ""))
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        corr = int(e.get("args", {}).get("correlation", -1))
        if cat in SPAN_CATS and name.startswith(PREFIX):
            spans[e.get("tid")].append((ts, ts + dur, name))
            count[name] += 1
            if name == ANY_THREAD:
                anywhere.append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            launches[e.get("tid")].append((ts, corr))
        elif cat == "kernel":
            kernel_us[corr] = kernel_us.get(corr, 0.0) + dur
    anywhere.sort()
    starts = [a for a, _ in anywhere]
    n_launch: Dict[str, int] = defaultdict(int)
    us: Dict[str, float] = defaultdict(float)
    for tid, calls in launches.items():
        calls.sort()
        own = sorted(spans.get(tid, []), key=lambda s: (s[0], -s[1]))
        stack: List = []
        i = 0
        for ts, corr in calls:
            if corr not in kernel_us:
                continue
            while i < len(own) and own[i][0] <= ts:
                while stack and stack[-1][1] < own[i][0]:
                    stack.pop()
                stack.append(own[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            # spans on one thread nest: the stack is every span open here
            names = {s[2] for s in stack if s[1] >= ts}
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and anywhere[k][1] >= ts:
                names.add(ANY_THREAD)
            for name in names:
                n_launch[name] += 1
                us[name] += kernel_us[corr]
    return dict(count), dict(n_launch), dict(us)


def device(run) -> Optional[DeviceSpans]:
    if not hasattr(run, "_device_spans"):
        run._device_spans = _device_pass(run)
    return run._device_spans


def host(run) -> Optional[HostSpans]:
    if not hasattr(run, "_host_spans"):
        run._host_spans = _host_pass(run)
    return run._host_spans


def _device_pass(run) -> Optional[DeviceSpans]:
    if _program() is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness.trace import _events

    dev = run.loop.dev
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        info = run.loop.traced()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    count, launches, us = reduce(_events(prof, run.loop.scratch))
    return DeviceSpans(info["batches"], info["draws"], count, launches, us)


def _host_pass(run) -> Optional[HostSpans]:
    profiling = _program()
    if profiling is None:
        return None
    import torch

    dev = run.loop.dev
    with profiling.collect() as table:
        info = run.loop.traced()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return HostSpans(info["batches"], dict(table))
