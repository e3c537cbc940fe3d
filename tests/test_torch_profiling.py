"""utils/profiling.py (torch.profiler traces and the program's spans) and
utils/devices.py of the port on the CPU: the trace file holds the ops run
inside the block and none run after it; the spans are null when off,
reach the profiler's trace nested as the program runs them, count in
``collect()``, change no result and enter no exported graph; the device
helpers enumerate and report placements, with no fallback to the CPU when
the card is asked for."""
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.engine.predict import (
    _placer,
    _serve_batches,
    make_packed_logits_fn,
    make_packed_predict_step,
)
from multimodal_auv_torch.engine.steps import make_train_step
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
    make_unimodal_bundle,
)
from multimodal_auv_torch.pipelines.unimodal import unimodal_predict_and_save
from multimodal_auv_torch.utils import devices as D
from multimodal_auv_torch.utils import profiling
from multimodal_auv_torch.utils.profiling import collect, span, trace


def _events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_the_block_ops(tmp_path):
    log_dir = str(tmp_path / "prof")
    x = torch.randn(64, 64)
    with trace(log_dir, device="cpu") as d:
        assert d == log_dir
        for _ in range(3):
            y = torch.mm(x, x)
        torch.cumsum(y, 0)
    torch.flip(y, (0,))  # after the block: not traced
    names = [e.get("name", "") for e in _events(log_dir)]
    assert sum(n == "aten::mm" for n in names) == 3
    assert "aten::cumsum" in names
    assert "aten::flip" not in names


def test_trace_writes_one_file_per_block(tmp_path):
    log_dir = str(tmp_path / "prof")
    for _ in range(2):
        with trace(log_dir, device="cpu"):
            torch.ones(3).sum()
    assert len(glob.glob(os.path.join(log_dir, "*.pt.trace.json"))) == 2


def test_trace_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "p")):
            pass


def test_available_devices_and_setup(monkeypatch, tmp_path):
    assert D.get_available_devices("cpu") == [torch.device("cpu")]
    want = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else [])
    assert D.get_available_devices() == want  # no CPU fallback
    with pytest.raises(ValueError):
        D.get_available_devices("tpu")
    monkeypatch.delenv("MULTIMODAL_AUV_ROOT", raising=False)
    assert D.setup_environment_and_devices(str(tmp_path), "cpu") == (
        str(tmp_path), [torch.device("cpu")])
    monkeypatch.setenv("MULTIMODAL_AUV_ROOT", "/elsewhere")
    assert D.setup_environment_and_devices(str(tmp_path), "cpu")[0] == \
        "/elsewhere"


def test_check_model_devices_module_and_tree():
    m = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.BatchNorm1d(3))
    got = D.check_model_devices(m)
    assert set(got) == {"0.weight", "0.bias", "1.weight", "1.bias",
                        "1.running_mean", "1.running_var",
                        "1.num_batches_tracked"}
    assert set(got.values()) == {torch.device("cpu")}
    post = PackedPosterior(torch.zeros(4), torch.ones(4),
                           {"bn": {"scale": torch.ones(2)}})
    tree = {"post": post, "stats": [torch.zeros(1), (torch.ones(1),)]}
    got = D.check_model_devices(tree)
    assert sorted(got) == ["['post'].det['bn']['scale']", "['post'].mu",
                           "['post'].rho", "['stats'][0]",
                           "['stats'][1][0]"]


# -- spans ----------------------------------------------------------------

B, MC, SIZE = 2, 4, 32


def _bn_layers(bundle) -> int:
    """BatchNorm layers of one forward: the statistics tree's entries."""
    def count(tree):
        if "mean" in tree:
            return 1
        return sum(count(v) for v in tree.values() if isinstance(v, dict))
    return count(bundle.batch_stats)


def _u8(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, SIZE, SIZE, c), dtype=np.uint8)
            for c in (3, 3, 1)]


def _mm_bundle():
    return make_multimodal_bundle(7, BNNPriorSpec(),
                                  torch.Generator().manual_seed(0),
                                  ArchConfig.micro(), device="cpu")


def _sss_bundle():
    return make_unimodal_bundle(1, 7, BNNPriorSpec(),
                                torch.Generator().manual_seed(0),
                                ArchConfig.micro(), device="cpu")


def _packed_predict(bundle):
    """Two batches through the packed pipeline's loop; the outputs."""
    step = make_packed_predict_step(bundle, MC, mc_chunk=2)
    outs = []

    def kept(*args):
        out = step(*args)
        outs.append(out)
        return out

    class Sink:
        def writerow(self, row):
            pass

    batches = [(*_u8(k), ["a", "b"]) for k in range(2)]
    _serve_batches(kept, bundle.post, bundle.batch_stats,
                   _placer(bundle, "cpu"), batches, Sink(),
                   torch.Generator().manual_seed(5), nominal=B)
    return [o["mean_prob"] for o in outs]


def _unimodal_predict(bundle, path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SIZE, SIZE, 1)).astype(np.float32)
    unimodal_predict_and_save(bundle, [(None, None, x, ["a", "b"])] * 2,
                              str(path), MC, model_type="sss",
                              generator=torch.Generator().manual_seed(5),
                              device="cpu")
    with open(path) as f:
        return f.read()


def _train(bundle, steps=2):
    """``steps`` remat train steps of MC 2 (chunk 1); the state's leaves."""
    from multimodal_auv_torch.engine.loops import _device_batch

    state = BayesTrainState(bundle.post,
                            make_optimizer(1e-3, 1e-5).init(bundle.post),
                            bundle.batch_stats)
    step = make_train_step(bundle.module, bundle.meta, BNNPriorSpec(), 2,
                           remat="on")
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        batch = {"label": np.array([0, 3]),
                 "x": rng.standard_normal((B, SIZE, SIZE, 1)).astype(
                     np.float32)}
        inputs, labels, mask, _ = _device_batch(batch, [batch["x"]], B,
                                                "cpu")
        state, _ = step(state, inputs, labels, mask, gen, 1e-6, 2.0)
    post = state.post
    return [post.mu.detach().clone(), post.rho.detach().clone()] + [
        v.detach().clone() for v in _leaves(state.batch_stats)]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _profiled(fn, tmp_path):
    """(fn's result, the Chrome trace's auv.* events) under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "spans.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("auv.")]
    return out, spans


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _named(spans, name):
    return [e for e in spans if e["name"] == name]


def test_span_is_one_shared_null_context_when_off(monkeypatch):
    """Off: the same null context for every name, no record_function and
    nothing in a table closed before the spans run."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        refuse)
    assert span("auv.bn") is span("auv.conv")
    with collect() as table:
        pass
    _packed_predict(_mm_bundle())
    assert table == {}


def test_spans_off_reach_no_profiler_event(tmp_path):
    """Spans entered before a profiler starts leave no event in it."""
    bundle = _mm_bundle()
    _packed_predict(bundle)
    _, spans = _profiled(lambda: torch.ones(3).sum(), tmp_path)
    assert spans == []


@pytest.mark.parametrize("path", ["packed_predict", "unimodal_predict"])
def test_predict_spans_nest_in_the_profiler_trace(path, tmp_path):
    if path == "packed_predict":
        bundle = _mm_bundle()
        _, spans = _profiled(lambda: _packed_predict(bundle), tmp_path)
    else:
        bundle = _sss_bundle()
        _, spans = _profiled(
            lambda: _unimodal_predict(bundle, tmp_path / "u.csv"), tmp_path)
    steps = _named(spans, "auv.step")
    assert len(steps) == 2
    for name in ("auv.bn", "auv.conv", "auv.sample"):
        got = _named(spans, name)
        assert got, name
        assert all(any(_inside(e, s) for s in steps) for e in got), name
    # the copies in and out lie outside the steps
    for name, n in (("auv.place", 2 * (4 if path == "packed_predict"
                                       else 2)), ("auv.drain", 2)):
        got = _named(spans, name)
        assert len(got) == n, name
        assert not any(_inside(e, s) for e in got for s in steps), name


def test_train_spans_nest_in_the_profiler_trace(tmp_path):
    """The train step: backward and the guard inside the step; remat's
    re-forward runs BatchNorm again inside the backward, on the thread
    that runs the backward (the caller's, on the CPU)."""
    bundle = _sss_bundle()
    _, spans = _profiled(lambda: _train(bundle), tmp_path)
    steps = _named(spans, "auv.step")
    assert len(steps) == 2
    backward = _named(spans, "auv.backward")
    assert len(backward) == 2
    assert all(any(_inside(b, s) for s in steps) for b in backward)
    guards = _named(spans, "auv.guard")
    assert len(guards) == 2
    assert all(any(_inside(g, s) for s in steps) for g in guards)
    assert not any(_inside(g, b) for g in guards for b in backward)
    bn = _named(spans, "auv.bn")
    in_backward = [e for e in bn if any(
        b["ts"] <= e["ts"] and e["ts"] + e["dur"] <= b["ts"] + b["dur"]
        for b in backward)]
    assert len(in_backward) == len(bn) // 2 == 2 * 2 * _bn_layers(bundle)
    assert _named(spans, "auv.place")


def test_collect_counts_spans_per_draw():
    """BatchNorm spans per draw are the trunks' BatchNorm layers (three
    trunks in the multimodal model), twice in training (remat's
    re-forward); one guard per step."""
    mm, sss = _mm_bundle(), _sss_bundle()
    with collect() as table:
        _packed_predict(mm)
    assert table["auv.bn"][0] == 2 * MC * _bn_layers(mm)
    assert _bn_layers(mm) == 3 * _bn_layers(sss)
    assert table["auv.conv"][0] == table["auv.bn"][0]
    assert table["auv.step"][0] == 2 and table["auv.drain"][0] == 2
    assert table["auv.sample"][0] == 2 * MC // 2
    assert all(c > 0 and s > 0 for c, s in table.values())
    with collect() as table:
        _train(sss, steps=3)
    assert table["auv.bn"][0] == 3 * 2 * 2 * _bn_layers(sss)
    assert table["auv.guard"][0] == 3 and table["auv.backward"][0] == 3
    assert table["auv.step"][0] == 3 and table["auv.place"][0] == 3
    # remat samples each chunk again in the backward
    assert table["auv.sample"][0] == 3 * 2 * 2


def test_collect_counts_every_thread_and_nests():
    with collect() as outer:
        with collect() as inner:
            threads = [threading.Thread(target=lambda: [
                span("auv.x").__enter__().__exit__(None, None, None)
                for _ in range(100)]) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        with span("auv.x"):
            pass
    assert inner["auv.x"][0] == 400
    assert outer["auv.x"][0] == 401
    assert profiling._TABLES == []


@pytest.mark.parametrize("path", ["packed_predict", "unimodal_predict",
                                  "train"])
def test_results_are_bit_equal_with_spans_off_collected_profiled(
        path, tmp_path):
    def run():
        if path == "packed_predict":
            return _packed_predict(_mm_bundle())
        if path == "unimodal_predict":
            return _unimodal_predict(_sss_bundle(), tmp_path / "u.csv")
        return _train(_sss_bundle())

    off = run()
    with collect():
        collected = run()
    profiled, _ = _profiled(run, tmp_path)
    if path == "unimodal_predict":
        assert off == collected == profiled
        return
    for a, b, c in zip(off, collected, profiled):
        assert torch.equal(a, b) and torch.equal(a, c)


def _export_nodes(which):
    from multimodal_auv_torch.engine.mc import stacked_mc_logits
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal
    from multimodal_auv_torch.serving import _flatten_state

    bundle = _mm_bundle()
    leaves, unflatten = _flatten_state(bundle)
    if which == "packed":
        logits_fn = make_packed_logits_fn(bundle, mc_chunk=2)
    else:
        def logits_fn(post, batch_stats, u8_inputs, seeds, mask):
            return stacked_mc_logits(
                bundle.module, bundle.meta, post, batch_stats,
                normalize_multimodal(*u8_inputs), seeds, rows=2,
                sample_dtype=torch.bfloat16, batch_mask=mask)

    class Program(torch.nn.Module):
        def forward(self, state_leaves, u8_inputs, seeds, mask):
            post, batch_stats = unflatten(state_leaves)
            return logits_fn(post, batch_stats, u8_inputs, seeds, mask)

    u8 = tuple(torch.from_numpy(a) for a in _u8(0))
    args = (leaves, u8, torch.zeros((1, 2), dtype=torch.int64),
            torch.ones(B))
    with torch.no_grad():
        program = torch.export.export(Program(), args, strict=False)
    nodes = list(program.graph_module.graph.nodes)
    for _, sub in program.graph_module.named_modules():
        if sub is not program.graph_module and hasattr(sub, "graph"):
            nodes += list(sub.graph.nodes)
    return nodes


@pytest.mark.parametrize("which", ["packed", "stacked"])
def test_exported_graphs_hold_no_span(which):
    """torch.export of the serving artifact's logits functions: the same
    node count plainly and inside collect() and a profiler, and no
    profiler op."""
    plain = _export_nodes(which)
    with collect() as table, profile(activities=[ProfilerActivity.CPU]):
        spanned = _export_nodes(which)
    assert len(spanned) == len(plain)
    assert not any("profiler" in str(n.target) for n in spanned)
    assert "auv.bn" not in table
