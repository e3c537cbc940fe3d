"""The program's spans as the benchmark reads them (``harness/spans.py``):
the reduction of a hand-written trace, and a traced micro run on the CPU
in which the new host-clock metrics read, the device ones read nothing,
and every other metric reads as it does without them."""
import json

import pytest

import run
from conftest import micro_cell
from harness import spans


def _span(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(ts, corr, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": 1000 + corr,
            "dur": dur, "tid": 7, "args": {"correlation": corr}}


def test_reduce_attributes_kernels_by_thread_and_nesting():
    events = [
        # thread 1: a step holding a conv and two BatchNorms
        _span("auv.step", 0, 100),
        _span("auv.conv", 10, 10), _launch(12, 1),
        _span("auv.bn", 30, 10), _launch(31, 2), _launch(35, 3),
        _span("auv.bn", 50, 10, cat="cpu_op"), _launch(55, 4),
        _launch(70, 5),                    # in the step alone
        _span("auv.backward", 80, 60),
        _launch(85, 6, cat="cuda_driver"),  # the backward's own thread
        _launch(150, 9),                   # after every span
        # thread 2 (autograd's): a re-forward's BatchNorm in the backward
        _span("auv.bn", 90, 20, tid=2), _launch(95, 7, tid=2),
        _launch(120, 8, tid=2),            # in the backward alone
        _launch(5, 10, tid=2),             # in thread 1's step: not its
        _span("other", 0, 200),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1,
         "dur": 50, "args": {"correlation": 11}}, _launch(32, 11),
    ]
    for corr, dur in ((1, 3.0), (2, 5.0), (3, 7.0), (4, 11.0), (5, 13.0),
                      (6, 17.0), (7, 19.0), (8, 23.0), (9, 29.0),
                      (10, 31.0)):
        events.append(_kernel(corr, dur))
    count, launches, us = spans.reduce(events)
    assert count == {"auv.step": 1, "auv.conv": 1, "auv.bn": 3,
                     "auv.backward": 1}
    assert launches == {"auv.step": 6, "auv.conv": 1, "auv.bn": 4,
                        "auv.backward": 3}
    assert us == {"auv.step": 3 + 5 + 7 + 11 + 13 + 17,
                  "auv.conv": 3.0, "auv.bn": 5 + 7 + 11 + 19.0,
                  "auv.backward": 17 + 19 + 23.0}


def test_reduce_of_a_trace_without_spans_is_empty():
    assert spans.reduce([_launch(1, 1), _kernel(1, 5.0)]) == ({}, {}, {})


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "_program", lambda: None)

    class Run:
        pass

    r = Run()
    assert spans.device(r) is None and spans.host(r) is None
    from harness.spec import reader

    for name in ("bn_ms_per_draw.train", "bn_launches_per_draw.predict",
                 "conv_ms_per_draw.sss_predict", "place_ms.train",
                 "guard_ms.train", "backward_ms_per_step.train"):
        assert reader(name)(r) is None, name


NEW = ("bn_ms_per_draw", "bn_launches_per_draw", "conv_ms_per_draw",
       "place_ms", "guard_ms", "backward_ms_per_step")
HOST = ("place_ms", "guard_ms")


@pytest.fixture(scope="module", autouse=True)
def _environment():
    run.set_environment()


@pytest.mark.parametrize("name", ("mm_predict_b128", "sss_train_b128",
                                  "sss_predict_b128"))
def test_traced_micro_run_reads_the_spans(name):
    """New host-clock metrics read, the device ones are None on the CPU;
    the other metrics read what a run without the new entries reads."""
    cell = micro_cell(name)
    new = [m for m in cell.per_layer if m["name"].split(".")[0] in NEW]
    assert new and all(m["workloads"] == [name] for m in new)
    out = run.run_cell(cell, 3_000_000_031, 0.5, True, "cpu")
    line = json.loads(run.result_line(out))
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for m in new:
        base = m["name"].split(".")[0]
        if base in HOST:
            assert got[m["name"]]["value"] > 0, m["name"]
        else:
            assert m["name"] not in got, m["name"]
    old = micro_cell(name)
    old.per_layer = [m for m in old.per_layer if m not in new]
    before = run.run_cell(old, 3_000_000_031, 0.5, True, "cpu")
    assert set(before["metrics"]) == set(got) - {m["name"] for m in new}
    assert before["correct"], before["checks"]
