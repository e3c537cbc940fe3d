"""The yardstick's arithmetic: FLOPs from layer shapes, the samplers'
least times, the forbidden-module check, the reference's independence."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def test_flops_match_resnet50_published_count():
    from harness.flops import trunk_macs

    # torchvision's ResNet-50 at 224 px: 4.09 GMAC with its 1000-class fc
    macs = trunk_macs(224, 3, (3, 4, 6, 3), 64) + 2048 * 1000
    assert abs(macs / 4.09e9 - 1) < 0.01


def test_flops_of_the_configurations():
    from harness.flops import forward_flops

    cfg = lambda n: json.load(open(os.path.join(BENCH, "configs", n)))
    mm = forward_flops(cfg("multimodal_r50_bnn.json"))
    sss = forward_flops(cfg("unimodal_r50_bnn_sss.json"))
    # three trunks (3, 3, 1 channels) at 256 px against one 1-channel
    assert 3.0 < mm / sss < 3.1
    assert abs(mm * 32 * 20 / 20.4e12 - 1) < 0.01  # a b32 x 20 batch


def test_sampler_bound_of_kernel_1_at_chunk_2():
    from harness.bounds import least_ms, sampler_call

    nbytes, ops = sampler_call("split", 73_305_088, 2, "bfloat16",
                               "bfloat16", fast=True)
    assert round(nbytes / 1e9, 3) == 0.586
    assert round(least_ms(nbytes, ops), 4) == 0.1751


def test_sampler_bound_kinds():
    from harness.bounds import sampler_call

    P = 1 << 20
    assert sampler_call("stacked", P, 1, "float32", "float32") == (
        12 * P, (P // 2) * 53)
    assert sampler_call("eps", P, 2, "float32", "float32") == (
        8 * P, (P // 2) * 2 * 49)
    with pytest.raises(ValueError):
        sampler_call("other", P, 1, "float32", "float32")


def test_forbidden_modules_compare_whole_top_level_names():
    import run

    assert run.forbidden_modules(["multimodal_auv_torch.engine",
                                  "multimodal_auv_torch", "jaxtyping",
                                  "flaxen.x", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                  "multimodal_auv_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "multimodal_auv_tpu"]


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{BENCH!r}, "
         f"{ROOT!r}]\n{code}\nprint(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return {m.split(".")[0] for m in out.stdout.split()}


def test_reference_imports_nothing_of_the_program_or_jax():
    tops = _modules_after("import reference.train, reference.predict, "
                          "reference.noise, reference.layout")
    assert "torch" in tops
    for name in ("multimodal_auv_torch", "multimodal_auv_tpu", "jax",
                 "jaxlib", "flax"):
        assert name not in tops


def test_a_run_loads_no_jax():
    code = ("import conftest, run\nrun.set_environment()\n"
            "out = run.run_cell(conftest.micro_cell('sss_predict_b128'), 7, "
            "0.5, True, 'cpu')\nassert out['correct'], out['checks']")
    tops = _modules_after("sys.path.insert(0, "
                          f"{os.path.join(BENCH, 'tests')!r})\n" + code)
    assert "multimodal_auv_torch" in tops
    for name in ("multimodal_auv_tpu", "jax", "jaxlib", "flax"):
        assert name not in tops


def test_steady_trace_reduction():
    """Busy time is the union of device intervals over their extent."""
    from harness.trace import reduce_steady

    k = lambda ts, dur: {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                         "dur": dur, "args": {"correlation": 1}}
    host = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": 0, "dur": 500, "tid": 1}
    t = reduce_steady([k(100, 50), k(120, 50), k(200, 100), host])
    assert t.window_us == 200 and t.busy_us == 170
    assert len(t.kernels()) == 3
    assert reduce_steady([host]).busy_us == 0
