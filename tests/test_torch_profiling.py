"""utils/profiling.py::trace (torch.profiler) and utils/devices.py of the
port on the CPU: the trace file holds the ops run inside the block and
none run after it; the device helpers enumerate and report placements,
with no fallback to the CPU when the card is asked for."""
import glob
import json
import os

import pytest
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.utils import devices as D
from multimodal_auv_torch.utils.profiling import trace


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
