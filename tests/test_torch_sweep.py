"""The port's patch-size sweep (pipelines/sweep.py) against the JAX
package's on the CPU: a micro() sweep of 2 combos x 1 epoch through both,
the summary CSV's schema and rows equal to JAX's (bathy and SSS sizes, a
finite final accuracy), and each combo's ledgers with JAX's columns. The
weights and noise differ across frameworks, so the accuracies are held
to [0, 1], not to each other."""
import csv
import os

import numpy as np
import pytest
import torch

from multimodal_auv_torch.models.model_utils import ArchConfig as TArch
from multimodal_auv_torch.pipelines import run_patch_size_sweep as t_sweep
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.pipelines import run_patch_size_sweep as j_sweep
from tests.fixtures.make_tree import make_training_tree


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_sweep_micro_matches_jax(tmp_path, monkeypatch):
    root = make_training_tree(str(tmp_path / "data"), n_samples=6)
    monkeypatch.chdir(tmp_path)
    kw = dict(bathy_sizes=(10, 30), sss_sizes=(30,), num_epochs=1, num_mc=2,
              batch_size=3)
    jres = j_sweep(root, str(tmp_path / "jax"), arch=JArch.micro(), **kw)
    tres = t_sweep(root, str(tmp_path / "torch"), arch=TArch.micro(),
                   device="cpu", **kw)

    jsum = _rows(tmp_path / "jax" / "patch_sweep_summary.csv")
    tsum = _rows(tmp_path / "torch" / "patch_sweep_summary.csv")
    assert tsum[0] == jsum[0] == ["bathy_patch_m", "sss_patch_m",
                                  "final_eval_accuracy"]
    assert [r[:2] for r in tsum[1:]] == [r[:2] for r in jsum[1:]] == [
        ["10", "30"], ["30", "30"]]
    for r in tsum[1:]:
        assert 0.0 <= float(r[2]) <= 1.0
    assert [(r["bathy"], r["sss"]) for r in tres] == [
        (r["bathy"], r["sss"]) for r in jres]
    assert [r["accuracy"] for r in tres] == [r[2] for r in tsum[1:]]

    for combo in ("b10_s30", "b30_s30"):
        for name in ("multimodal_train_results.csv",
                     "multimodal_eval_results.csv"):
            j = _rows(tmp_path / "jax" / combo / name)
            t = _rows(tmp_path / "torch" / combo / name)
            assert t[0] == j[0] and len(t) == len(j) == 2, (combo, name)
            # the patch types the combo trained with
            assert t[1][-2:] == j[1][-2:], (combo, name)
            assert np.isfinite(float(t[1][2])), (combo, name)
        assert os.listdir(tmp_path / "torch" / combo / "tb")

    # a second sweep appends to the summary without a second header
    t_sweep(root, str(tmp_path / "torch"), arch=TArch.micro(), device="cpu",
            **dict(kw, bathy_sizes=(10,)))
    tsum = _rows(tmp_path / "torch" / "patch_sweep_summary.csv")
    assert len(tsum) == 4 and tsum[3][:2] == ["10", "30"]


def test_sweep_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep(str(tmp_path), str(tmp_path / "s"), arch=TArch.micro())
