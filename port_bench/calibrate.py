"""Readings from which a cell's comparison limits are set.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 5 [--out file.jsonl]

In one process, for each seed: the cell's set-up and a short window at
its own load (as a run makes them), then every compared number of the
program against the reference, and, for the control seeds, of the
reference at float8 (``run.run_cell(control="fp8")``) against it. One
JSON line per seed. ``--fault <name>`` plants one of ``harness/faults.py``
in the program first. A limit lies above the program's largest reading
over the seeds and below the control's smallest (``limits/``; PERF.md
gives the readings).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None,
                   help="plant a fault of harness/faults.py in the program")
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    from harness import cells, faults
    from harness.spec import load_cell

    if args.fault:
        faults.plant(args.fault)
    cell = load_cell(run.ROOT, args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="port_bench_") as scratch:
            loop = cells.ENTRIES[cell.traffic["entry"]](cell, seed, "cuda",
                                                        scratch)
            loop.setup()
            win = loop.window(args.seconds)
            loop.free()
            row = {"cell": cell.name, "seed": seed, "items": win["items"],
                   "fault": args.fault, "program": loop.judge(None)}
            if seed in control:
                row["control"] = loop.judge("fp8")
            del loop
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
