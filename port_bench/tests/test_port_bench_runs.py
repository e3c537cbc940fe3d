"""Whole runs of each cell at micro sizes on the CPU: the result line,
the reference against the program, and the comparison's control and
planted faults, each of which must come out not correct."""
import json

import pytest
import torch

import run
from conftest import micro_cell

CELLS = ("mm_predict_b128", "sss_train_b128", "sss_predict_b128")


@pytest.fixture(scope="module", autouse=True)
def _environment():
    run.set_environment()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_result_line_and_reference_agree(name, trace):
    out = run.run_cell(micro_cell(name), 3_000_000_019, 0.5, bool(trace),
                       "cpu")
    line = json.loads(run.result_line(out))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == want
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = micro_cell(name)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert any(k.startswith("mfu.") for k in line["metrics"])
        assert any(k.startswith("dispatch_ms.") for k in line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in line["metrics"].values():
            assert m["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_at_lower_precision_is_not_correct(name):
    out = run.run_cell(micro_cell(name), 3_000_000_021, 0.5, False, "cpu",
                       control="fp8")
    assert not out["correct"], out["checks"]


FAULTS = [("mm_predict_b128", "half_batch"),
          ("mm_predict_b128", "altered_answer"),
          ("mm_predict_b128", "class_order"),
          ("sss_predict_b128", "half_batch"),
          ("sss_predict_b128", "altered_answer"),
          ("sss_predict_b128", "class_order"),
          ("sss_train_b128", "half_batch"), ("sss_train_b128", "unchanged_state")]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_planted_fault_is_not_correct(name, fault):
    from harness import faults

    saved = faults.plant(fault)
    try:
        out = run.run_cell(micro_cell(name), 3_000_000_023, 0.5, False,
                           "cpu")
    finally:
        faults.undo(saved)
    assert not out["correct"], out["checks"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sss_predict_b128", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_short_run_on_the_card_is_correct(card):
    from harness.spec import load_cell

    cell = load_cell(run.ROOT, "sss_predict_b128")
    out = run.run_cell(cell, 3_000_000_029, 2.0, False, card)
    assert out["correct"], out["checks"]


def test_a_directory_of_the_benchmark_alone_runs_nothing(tmp_path):
    """With only BENCHMARK.json and port_bench/ (no program beside them)
    a run fails before printing a result."""
    import os
    import shutil
    import subprocess
    import sys

    from conftest import BENCH, ROOT

    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("_cache", "_runs",
                                                  "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path[:0] = ['port_bench', 'port_bench/tests']\n"
            "import conftest, run\nrun.set_environment()\n"
            "out = run.run_cell(conftest.micro_cell('sss_predict_b128'), 1, "
            "0.5, False, 'cpu')\nprint(run.result_line(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "multimodal_auv_torch" in proc.stderr
