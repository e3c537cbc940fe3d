"""Failures the port handles as the JAX package does: a file that fails to
decode in any way is a logged zeros image in a packed cache (never the end
of the pack), and a posterior checkpoint that cannot be written for any
reason is logged and returns None (never the end of a training loop)."""
import logging

import numpy as np
import pytest

import multimodal_auv_torch.data.transforms as ttransforms
import multimodal_auv_tpu.data.transforms as jtransforms
from multimodal_auv_torch.data import datasets as tdatasets
from multimodal_auv_torch.data import packing as tpacking
from multimodal_auv_tpu.data import datasets as jdatasets
from multimodal_auv_tpu.data import packing as jpacking
from tests.fixtures.make_tree import make_inference_tree, make_training_tree


def _raise_runtime_error(path, *a, **k):
    raise RuntimeError(f"decoder failed on {path}")


@pytest.mark.parametrize("kind", ["inference", "training"])
def test_pack_survives_any_decode_error_as_jax(tmp_path, monkeypatch, kind):
    """Both packages' decoder raises RuntimeError (not an OSError or a
    ValueError) on every file: both packs finish, and their arrays and
    names are equal (every image the zeros dummy)."""
    monkeypatch.setattr(ttransforms, "load_image_u8", _raise_runtime_error)
    monkeypatch.setattr(jtransforms, "load_image_u8", _raise_runtime_error)
    if kind == "inference":
        root = make_inference_tree(str(tmp_path / "dives"), n_samples=3)
        tds = tdatasets.InferenceFolderDataset(root, image_size=32)
        jds = jdatasets.InferenceFolderDataset(root, image_size=32)
        tpacking.pack_inference_dataset(tds, str(tmp_path / "t"), size=32)
        jpacking.pack_inference_dataset(jds, str(tmp_path / "j"), size=32)
        got = tpacking.load_packed(str(tmp_path / "t"))
        want = jpacking.load_packed(str(tmp_path / "j"))
    else:
        root = make_training_tree(str(tmp_path / "tree"), n_samples=4)
        tds = tdatasets.MultimodalFolderDataset(root, image_size=32)
        jds = jdatasets.MultimodalFolderDataset(root, image_size=32)
        got = tpacking.pack_training_dataset(tds, str(tmp_path / "t"),
                                             "30m", "30m", size=32)
        want = jpacking.pack_training_dataset(jds, str(tmp_path / "j"),
                                              "30m", "30m", size=32)
    for key in ("main", "bathy", "sss"):
        assert not np.asarray(got[key]).any()
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    other = "names" if kind == "inference" else "labels"
    np.testing.assert_array_equal(np.asarray(got[other]),
                                  np.asarray(want[other]))


def test_save_model_logs_any_failure_as_jax(tmp_path, caplog):
    """A ``csv_path`` holding a NUL byte in the directory the checkpoint
    goes under (``dirname(dirname(csv_path))``) makes the write raise
    ValueError in both packages: each logs the failure and returns
    None."""
    import jax
    import torch

    from multimodal_auv_torch.bayes.packing import PackedPosterior
    from multimodal_auv_torch.engine.checkpointing import save_model
    from multimodal_auv_tpu.engine.checkpointing import (
        save_model as jax_save_model,
    )

    bad = str(tmp_path / "run\0x" / "csvs" / "ledger.csv")
    post = PackedPosterior(torch.zeros(8), torch.zeros(8), {})
    with caplog.at_level(logging.ERROR):
        assert save_model(post, bad, "multimodal") is None
        assert jax_save_model({"mu": jax.numpy.zeros(8)}, bad,
                              "multimodal") is None
    failures = [r for r in caplog.records
                if "Failed to save model checkpoint" in r.getMessage()]
    assert len(failures) == 2
