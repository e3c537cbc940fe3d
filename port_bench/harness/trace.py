"""Profiled stretches of a run, reduced to what the metric readers take.

Two passes, each writing its Chrome trace to a scratch directory and
reducing it:

``capture_steady`` runs batches under ``torch.profiler`` with the CUDA
activity alone (no host operators recorded, so the host runs at nearly
its own pace), with the first batch, the pipeline's fill, left out as the
profiler's warm-up (``reduce_steady``):

* device operations (kernels, copies, sets) of the recorded batches;
* the window: from the first device operation's start to the last one's
  end; the busy time: the union of their intervals.

CUPTI's records of the runtime calls still slow the host by some 10%, so
where the host is near the device's pace the steady window's idle share
reads high; ``metrics/idle_share.py`` takes the busy time a batch from
here and the time a batch from the untraced window instead.

``capture`` runs batches under the host and CUDA activities inside a span
``bench.traced`` that ends after a device synchronisation (``reduce``):

* device operations inside the span, the busy time and the span;
* the kernels launched inside the optimizer's step (by the correlation
  of each kernel with its launch call);
* the idle gaps of the device, each named by what the host was doing at
  its middle: of the threads' innermost operations running then, the one
  that started last. The host operators' recording slows the host, so
  these gaps are wider than the untraced run's.
"""
from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

SPAN = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SAMPLER_KERNEL = re.compile(
    r"\b(sampler_kernel|bf16_stacked_kernel|noise_kernel)\b")
OPTIMIZER_SPAN = "Optimizer.step#"


@dataclass
class Trace:
    window_us: float
    busy_us: float
    device: List[Tuple[str, str, float, float, int]]  # cat, name, ts, dur, corr
    optimizer_corr: set = field(default_factory=set)
    gaps_by_host: Dict[str, float] = field(default_factory=dict)

    def kernels(self):
        return [d for d in self.device if d[0] == "kernel"]

    def sampler_kernels(self):
        return [d for d in self.kernels() if SAMPLER_KERNEL.search(d[1])]

    def optimizer_kernels(self):
        return [d for d in self.kernels() if d[4] in self.optimizer_corr]

    def model_kernels(self):
        return [d for d in self.kernels()
                if not SAMPLER_KERNEL.search(d[1])
                and d[4] not in self.optimizer_corr]

    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for _, name, _, dur, _ in self.device:
            by[name] += dur
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in rows]

    def top_gaps(self, n: int = 10):
        rows = sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in rows]


def _union(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(host: List[Tuple[float, float, str]], points: List[float]):
    """For each of ``points`` (sorted), (start, name) of the innermost
    event of ``host`` (one thread's events, which nest, sorted by start)
    containing it, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append((stack[-1][0], stack[-1][2]) if stack else None)
    return out


def _name_points(host: Dict, points: List[float]) -> List[str]:
    """What the host was doing at each point: of the threads' innermost
    events containing it, the one that started last."""
    per = [_innermost(sorted(evs, key=lambda h: (h[0], -h[1])), points)
           for evs in host.values()]
    names = []
    for k in range(len(points)):
        hits = [p[k] for p in per if p[k] is not None]
        names.append(max(hits)[1] if hits else "(host idle)")
    return names


def reduce(events: List[Dict]) -> Trace:
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") in ("user_annotation", "cpu_op")]
    if not span:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    s = span[0]
    lo, hi = float(s["ts"]), float(s["ts"]) + float(s["dur"])
    device, runtime = [], []
    host: Dict = defaultdict(list)
    opt_spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            if ts + dur > lo and ts < hi:
                corr = int(e.get("args", {}).get("correlation", -1))
                device.append((cat, e["name"], ts, dur, corr))
        elif cat in HOST_CATS and lo <= ts <= hi:
            host[e.get("tid")].append((ts, ts + dur, e["name"]))
            if cat in ("cuda_runtime", "cuda_driver"):
                runtime.append((ts, ts + dur, e["name"],
                                int(e.get("args", {}).get("correlation", -1)),
                                e.get("tid")))
            if e["name"].startswith(OPTIMIZER_SPAN):
                opt_spans.append((ts, ts + dur))
    segments = _union([(max(ts, lo), min(ts + dur, hi))
                       for _, _, ts, dur, _ in device])
    busy = sum(b - a for a, b in segments)
    opt_spans.sort()
    starts = [a for a, _ in opt_spans]
    opt_corr = set()
    for a, b, _, corr, _ in runtime:
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and opt_spans[k][1] >= b:
            opt_corr.add(corr)
    gaps, prev = [], lo
    for a, b in segments:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    mids = [(a + b) / 2 for a, b in gaps]
    by_host: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, _name_points(host, mids)):
        by_host[name] += b - a
    return Trace(hi - lo, busy, device, opt_corr, dict(by_host))


def reduce_steady(events: List[Dict]) -> Trace:
    """The steady pass's trace (CUDA activity alone): the device's
    operations over their own extent."""
    device = [(e.get("cat"), e["name"], float(e.get("ts", 0)),
               float(e.get("dur", 0)),
               int(e.get("args", {}).get("correlation", -1)))
              for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device:
        return Trace(0.0, 0.0, [])
    lo = min(d[2] for d in device)
    hi = max(d[2] + d[3] for d in device)
    busy = sum(b - a for a, b in _union([(d[2], d[2] + d[3])
                                          for d in device]))
    return Trace(hi - lo, busy, device)


def _events(prof, scratch: str) -> List[Dict]:
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def capture_steady(fn: Callable[[Callable[[], None]], None], scratch: str,
                   device) -> Trace:
    """Run ``fn(next_batch)`` once under the profiler with the CUDA
    activity alone (the host's on a machine without a card); ``fn`` calls
    ``next_batch()`` as it hands over each batch. The first batch is the
    profiler's warm-up; the rest and the drain are recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    handed = [0]
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1 << 20)) as prof:
        def next_batch():
            if handed[0]:
                prof.step()
            handed[0] += 1

        fn(next_batch)
        if cuda:
            torch.cuda.synchronize(device)
    return reduce_steady(_events(prof, scratch))


def capture(fn: Callable[[], None], scratch: str, device) -> Trace:
    """Run ``fn`` once under the profiler and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    return reduce(_events(prof, scratch))
