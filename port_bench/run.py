"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, the card, the kernel library from its cache, the
posterior and batches made from the seed, the warm-up) is timed from the
start of this script to the start of the window; the window runs the
cell's loop for ``--seconds`` and its end-to-end metrics are all its work
over all its time. With ``--trace 1`` the per-layer metrics (``metrics/``)
are read from the window's host-clock spans and totals and from two
profiled passes after it (``harness/trace.py``): a few batches or steps
with the CUDA activity alone, the first of them left out, for the
device's busy and idle time; then a few under host and CUDA activities
for kernels, launches and what the host did in the device's gaps. Then the program's state is freed and the
reference recomputes a sample of the window's answers (``reference/``);
each compared number is printed beside its limit (``limits/<cell>.json``)
on standard error and, last, in the result line.

The result is the last line of standard output, one JSON object. The
exit code is not 0, and no result is printed, without enough cards, if
the program or the reference fails, or if a JAX module (``jax``,
``jaxlib``, ``flax``) or the JAX package (``multimodal_auv_tpu``) is
loaded in this process. The comparison's control (the reference at
float8 in the program's place) is read by ``calibrate.py``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_auv_tpu")
# every cache the program or torch may write, at fixed paths in the checkout
CACHES = {"MULTIMODAL_AUV_TORCH_BUILD_DIR": "kernels",
          "TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module names (whole names:
    ``multimodal_auv_torch`` is not ``multimodal_auv_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def set_environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, "_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def card_lines() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi: {e}"]
    return [f"card: {line}" for line in out.strip().splitlines()]


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control=None, t0: float = T0) -> dict:
    """Measure one run of ``cell``; the result object (without printing)."""
    import torch

    from harness import cells, program
    from harness import trace as tracing
    from harness.spec import reader

    dev = torch.device(device)
    # float32 means float32, in the program and in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = tempfile.mkdtemp(prefix="port_bench_")
    try:
        loop = cells.ENTRIES[cell.traffic["entry"]](cell, seed, dev, scratch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_setup = time.perf_counter()
        loop.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        win = loop.window(seconds)
        out = {"correct": False, "attempted": win["attempted"],
               "failed": win["attempted"] - win["items"]}
        metrics = {}
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": cell.chips}
        if trace:
            steady = {}
            idle = tracing.capture_steady(
                lambda hand: steady.update(loop.steady(hand)), scratch, dev)
            info = {}
            before = program.launches()
            tr = tracing.capture(lambda: info.update(loop.traced()), scratch,
                                 dev)
            after = program.launches()
            launched = {k: after[k] - before.get(k, 0) for k in after}
            run = Readings(cell, loop, win, tr, info, launched, idle, steady)
            for m in cell.per_layer:
                read = reader(m["name"])
                value = None if read is None else read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            out["_steady"] = {"batches_seen": run.steady_batches_seen(),
                              "device_ops": len(idle.device),
                              "busy_s": idle.busy_us / 1e6,
                              "window_s": idle.window_us / 1e6,
                              "window_batches": win["items"]
                              / cell.traffic["batch"]}
            device_info["busy_s"] = idle.busy_us / 1e6
            device_info["window_s"] = idle.window_us / 1e6
            out["breakdown"] = {"device_ops": tr.top_ops(),
                                "idle_gaps": tr.top_gaps()}
        else:
            for m in cell.end_to_end:
                if m["name"] == "setup_s":
                    value = setup_s
                elif m["name"] == cell.traffic["rate_metric"]:
                    value = win["items"] / win["seconds"]
                else:
                    continue
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
        out["metrics"] = metrics
        out["device"] = device_info
        loop.free()
        t_ref = time.perf_counter()
        values = loop.judge(control)
        out["_timing"] = {"before_setup_s": t_setup - t0,
                          "setup_phases_s": loop.phases,
                          "window_batch_intervals_s": [
                              round(x, 4) for x in loop.intervals],
                          "reference_s": time.perf_counter() - t_ref}
        checks = {k: {"value": values[k], "limit": lim}
                  for k, lim in cell.limits.items()}
        out["correct"] = all(c["value"] <= c["limit"]
                             for c in checks.values())
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


class Readings:
    """What a metric reader reads: the cell, its loop, the untraced
    window's totals and host-clock spans, the reduced traces of the
    profiled pass (``trace``: its batches ``traced`` and the program's
    kernel launches in them) and of the steady pass (``idle``; its
    batches in ``steady``)."""

    def __init__(self, cell, loop, window, trace, traced, launched,
                 idle=None, steady=None):
        self.cell, self.loop, self.window = cell, loop, window
        self.trace, self.traced, self.launched = trace, traced, launched
        self.idle, self.steady = idle, steady or {}

    def steady_batches_seen(self):
        """Batches (or steps) whose work the steady trace holds: its
        kernels over the kernels a batch launches, which the profiled
        pass (whole batches, from an empty queue to a synchronisation)
        counts; None without them."""
        per = len(self.trace.kernels()) / self.batches if self.batches else 0
        seen = len(self.idle.kernels()) if self.idle else 0
        if not per or not seen:
            return None
        return seen / per

    @property
    def draws(self) -> int:
        return self.traced["draws"]

    @property
    def batches(self) -> int:
        return self.traced["batches"]

    def sampler_calls(self):
        return self.loop.sampler_calls(self.launched)

    @property
    def P(self) -> int:
        return self.loop.lay.n_padded


def result_line(out: dict) -> str:
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: out[k] for k in keys if k in out})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    from harness.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules(sys.modules)
    if found:
        print(f"port_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    for line in card_lines():
        print(line, file=sys.stderr)
    print(f"timing: {json.dumps(out['_timing'])}", file=sys.stderr)
    if "_steady" in out:
        print(f"steady pass: {json.dumps(out['_steady'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(result_line(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
