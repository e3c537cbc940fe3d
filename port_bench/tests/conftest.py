"""Shared set-up of the benchmark's own tests (run from the repository
root: ``python -m pytest port_bench/tests``).

The cells are run at ``micro`` sizes on the CPU here: two stages of one
bottleneck, width 8, 32 px, float32 activations, batches of 4, the
configuration's and the mix's structure otherwise unchanged.
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

MICRO_CONFIG = {"stage_sizes": [1, 1], "width": 8, "image_size": 32,
                "activation_dtype": "float32"}
MICRO_TRAFFIC = {"batch": 4, "pool": 3, "warmup_batches": 1,
                 "trace_batches": 1, "check_batches": 6,
                 "idle_batches": 1}
MICRO_DRAWS = {"mm_predict_b128": 4, "sss_predict_b128": 4,
               "sss_train_b128": 2}


def micro_cell(name, root=ROOT, bench_dir=BENCH):
    from harness.spec import load_cell

    cell = load_cell(root, name, bench_dir)
    cell.config.update(MICRO_CONFIG)
    cell.traffic.update(MICRO_TRAFFIC, num_mc=MICRO_DRAWS[name])
    return cell


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
