"""What a run is asked to measure, found by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells and the
metrics. A cell names a configuration (``configs/<config>.json``, or the
file the configuration's entry gives) and a traffic mix
(``traffic/<traffic>.json``); its comparison limits are
``limits/<cell>.json``; a per-layer metric is read by
``metrics/<name>.py``, or, when no file has the whole name, by the file
of the name with its last dotted parts taken off (``mfu.train`` ->
``mfu.py``). A later cell, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; KeyError if there
    is none."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name, int(w["chips"]), cfg, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, bench_dir: str = HERE
           ) -> Optional[Callable]:
    """``read(run)`` of ``metrics/<name>.py``, else of the longest dotted
    prefix of the name that has a file; None if none has."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(bench_dir, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(
                "port_bench_metric_" + ".".join(parts[:n]).replace(".", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None
