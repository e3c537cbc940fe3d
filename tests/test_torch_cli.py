"""The port's CLI against the JAX package's: the same argv passes the same
keyword arguments to the pipelines (each monkeypatched to record them);
flags of paths not ported yet exit non-zero naming their ROADMAP item
(``data-prep``, ported, runs); the default ``--device cuda`` needs a card; the self-check
is offline and reports a crashing pipeline as a FAIL line."""
import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import multimodal_auv_torch.pipelines as pipelines
import multimodal_auv_tpu.pipelines as jpipelines
import multimodal_auv_tpu.utils.devices as jdevices
from multimodal_auv_torch import cli
from multimodal_auv_tpu import cli as jcli

PIPELINES = {"inference": "run_auv_inference",
             "retrain": "run_auv_retraining",
             "train-scratch": "run_AUV_training_from_scratch",
             "export-serving": "export_auv_serving_artifact"}
REQUIRED = {"inference": ["--data_dir", "/d", "--output_csv", "/o.csv"],
            "retrain": ["--data_dir", "/d"],
            "train-scratch": ["--root_dir", "/d"],
            "export-serving": ["--output_dir", "/a"]}
TRAINING = ["--bathy_patch_base", "10", "--sss_patch_base", "20",
            "--mc_chunk", "2", "--bf16_weights", "--strict_errors",
            "--resume_checkpoint", "/ck", "--packed_loader", "--remat", "off",
            "--process_id", "0", "--dist_timeout", "9", "--tiny"]
SET_ALL = {
    "inference": ["--batch_size", "8", "--num_mc_samples", "3",
                  "--num_classes", "5", "--model_weights", "w.pt",
                  "--allow_random_init", "--mc_chunk", "2", "--packed_loader",
                  "--dvp", "--fast_sampling", "off", "--bn_mode", "eval",
                  "--tiny"],
    "retrain": ["--batch_size_multimodal", "6", "--num_epochs_multimodal",
                "2", "--num_mc_samples", "4", "--learning_rate_multimodal",
                "0.01", "--weight_decay_multimodal", "0.1", "--num_classes",
                "4", "--devices", "gpu", "--model_weights", "w.pt",
                "--allow_random_init", "--freeze_backbone"] + TRAINING,
    "train-scratch": ["--epochs_multimodal", "3", "--num_mc", "4",
                      "--batch_size_multimodal", "6", "--lr_multimodal",
                      "0.01", "--num_classes", "4", "--devices", "gpu",
                      "--batch_size_unimodal", "2", "--pretrained_trunks",
                      "tv.pth"] + TRAINING,
    "export-serving": ["--batch_size", "poly", "--num_mc_samples", "6",
                       "--num_classes", "5", "--model_weights", "w.pt",
                       "--allow_random_init", "--mc_chunk", "3", "--dvp",
                       "--dvp_on_excess", "warn", "--platforms", "cpu",
                       "--fast_sampling", "off", "--bn_mode", "eval",
                       "--tiny"],
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(monkeypatch, module, name):
    seen = {}

    def fake(*args, **kwargs):
        assert not args
        seen.update(kwargs)
        return True

    monkeypatch.setattr(module, name, fake)
    return seen


def _arch_fields(arch):
    """The fields both ArchConfigs share; the activation dtype by name (a
    JAX scalar type has a __name__, a torch dtype prints as torch.<name>)."""
    dt = arch.dtype
    return (tuple(arch.stage_sizes), arch.width, arch.image_size,
            getattr(dt, "__name__", str(dt).split(".")[-1]))


@pytest.mark.parametrize("flags", ["defaults", "set_all"])
@pytest.mark.parametrize("command", list(PIPELINES))
def test_same_argv_same_kwargs_as_jax(monkeypatch, command, flags):
    """Both CLIs, given one argv, call the pipeline with the same keyword
    arguments: ``arch`` compared by its fields, the preemption guard by
    its type, and ``device`` on the port's side only."""
    monkeypatch.setattr(jdevices, "enable_compilation_cache", lambda: None)
    want = _record(monkeypatch, jpipelines, PIPELINES[command])
    got = _record(monkeypatch, pipelines, PIPELINES[command])
    argv = REQUIRED[command] + (SET_ALL[command] if flags == "set_all" else [])
    assert jcli.main([command] + argv) == 0
    assert cli.main([command] + argv) == 0
    assert got.pop("device") == "cuda"
    assert _arch_fields(got.pop("arch")) == _arch_fields(want.pop("arch"))
    if "preemption_guard" in want:
        assert (type(got.pop("preemption_guard")).__name__
                == type(want.pop("preemption_guard")).__name__
                == "PreemptionGuard")
    assert got == want


# item None: a parallel flag of item 8, ported since; it must reach the
# pipeline as the spec the JAX CLI builds. RUNS: a training flag of item 5,
# ported since; the CLI runs it on a micro() model. DATA_PREP: the
# data-prep subcommand of item 9, ported since; it runs on a raw tree.
# MC_SHARDS: the mc-sharded export of item 8a, ported since; it writes an
# mc-sharded artifact. DATA_SHARDS: the batch-sharded export of item 8b,
# ported since; it writes a data-sharded artifact. DVP_DATA_SHARDS: the
# data-sharded DVP export of item 8c, ported since; it writes a
# data-sharded DVP artifact.
RUNS = "runs"
DATA_PREP = "data-prep runs"
MC_SHARDS = "mc-sharded export runs"
DATA_SHARDS = "data-sharded export runs"
DVP_DATA_SHARDS = "data-sharded DVP export runs"
NOT_PORTED = [
    ("retrain", ["--mesh_data", "2"], None),
    ("retrain", ["--mesh_mc", "2"], None),
    ("retrain", ["--fsdp"], None),
    ("retrain", ["--coordinator", "localhost:1"], None),
    ("retrain", ["--num_processes", "2"], None),
    ("retrain", ["--async_checkpoints"], RUNS),
    ("retrain", ["--remat", "auto"], RUNS),
    ("train-scratch", ["--fsdp"], None),
    ("train-scratch", ["--async_checkpoints"], RUNS),
    ("train-scratch", ["--remat", "auto"], RUNS),
    ("export-serving", ["--mc_shards", "2"], MC_SHARDS),
    ("export-serving", ["--data_shards", "2"], DATA_SHARDS),
    ("export-serving", ["--dvp", "--data_shards", "2"], DVP_DATA_SHARDS),
    ("data-prep", [], DATA_PREP),
]


@pytest.mark.parametrize("command,extra,item", NOT_PORTED,
                         ids=[f"{c}{''.join(e[:1])}" for c, e, _ in NOT_PORTED])
def test_unported_flags_exit_non_zero(monkeypatch, capsys, tmp_path,
                                      command, extra, item):
    """A flag or subcommand of a path not ported yet: a non-zero exit and a
    message naming its ROADMAP item; the pipeline never runs. The mesh and
    multi-process flags (item 8, ported) instead reach the pipeline as the
    ``MeshSpec`` / ``DistSpec`` the JAX CLI builds from the same argv (the
    port's DistSpec has one field more, ``backend``, left None). The
    training flags of item 5, ported, run: one epoch of the subcommand on
    the CPU at micro() size with a resume checkpoint, exit 0, the
    checkpoint committed. The data-prep subcommand (item 9, ported) runs on a 3-frame
    synthetic raw tree and a bathymetry and an SSS GeoTIFF: exit 0 and the
    per-sample folders of tests/test_etl_pipeline.py. ``export-serving
    --mc_shards 2`` (item 8a, ported) writes an mc-sharded artifact on the
    CPU at micro() size that loads on two CPU shards; ``--data_shards 2``
    (item 8b, ported) a data-sharded one (one draw a chunk), which loads on
    two CPU shards with one worker thread each; ``--dvp --data_shards 2``
    (item 8c, ported) a data-sharded DVP one (all the draws in one
    chunk), which predicts on two CPU shards."""
    if item in (MC_SHARDS, DATA_SHARDS, DVP_DATA_SHARDS):
        from multimodal_auv_torch.models.model_utils import ArchConfig
        from multimodal_auv_torch.serving import load_predict_artifact

        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        monkeypatch.setattr(cli, "_arch", lambda args: ArchConfig.micro())
        out = str(tmp_path / "art")
        chunk = ["--mc_chunk", "1"] if item == DATA_SHARDS else []
        assert cli.main([command, "--output_dir", out, "--allow_random_init",
                         "--num_mc_samples", "4", "--num_classes", "3",
                         "--device", "cpu"] + chunk + extra) == 0
        meta = json.load(open(os.path.join(out, "meta.json")))
        art = load_predict_artifact(out, devices=["cpu", "cpu"])
        if item == MC_SHARDS:
            assert (meta["mc_shards"], meta["data_shards"], meta["mode"]) == (
                2, 1, "mc")
            assert (art.mc_shards, art.shard_rows, art.nchunks) == (2, 2, 1)
            return
        dvp = item == DVP_DATA_SHARDS
        assert (meta["mc_shards"], meta["data_shards"], meta["mode"]) == (
            1, 2, "dvp" if dvp else "mc")
        try:
            assert (art.data_shards, art.shard_rows, art.nchunks) == (
                (2, 4, 1) if dvp else (2, 1, 4))
            rng = np.random.default_rng(0)
            px = art.image_size
            out = art.predict(*[rng.integers(0, 255, (4, px, px, c),
                                             dtype=np.uint8)
                                for c in (3, 3, 1)], key=1)
            assert out["predicted"].shape == (4,)
        finally:
            art.close()
        return
    if item == DATA_PREP:
        from tests.test_torch_dataprep import _write_rasters
        from tests.test_etl_pipeline import _make_raw_tree

        raw = _make_raw_tree(str(tmp_path / "raw"), n=3)
        gdir = _write_rasters(str(tmp_path / "tiffs"))
        out = str(tmp_path / "out")
        assert cli.main([command, "--raw_optical_images_folder", raw,
                         "--geotiff_folder", gdir, "--output_folder", out]
                        + extra) == 0
        samples = os.path.join(out, "samples")
        assert sorted(os.listdir(samples)) == ["frame_0000", "frame_0001",
                                               "frame_0002"]
        for d in os.listdir(samples):
            assert {f"{d}.jpg", "row_data.csv", "unlabelled.txt",
                    "output_channel_1.png", "output_channel_2.png",
                    "grid_a_b_SSS.png", "combined_channels.png"} <= set(
                        os.listdir(os.path.join(samples, d)))
        assert os.path.exists(os.path.join(out, "processed_optical",
                                           "coords.csv"))
        return
    if item == RUNS:
        from multimodal_auv_torch.engine import checkpointing as ckpt
        from multimodal_auv_torch.models.model_utils import ArchConfig
        from tests.fixtures.make_tree import make_training_tree

        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        monkeypatch.setattr(cli, "_arch", lambda args: ArchConfig.micro())
        root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
        state = str(tmp_path / "state.pt")
        common = ["--batch_size_multimodal", "2", "--bathy_patch_base", "10",
                  "--sss_patch_base", "10", "--packed_loader",
                  "--resume_checkpoint", state, "--device", "cpu"]
        argv = {"retrain": ["--data_dir", root, "--num_epochs_multimodal",
                            "1", "--num_mc_samples", "2",
                            "--allow_random_init"],
                "train-scratch": ["--root_dir", root, "--epochs_multimodal",
                                  "1", "--num_mc", "2"]}[command]
        assert cli.main([command] + argv + common + extra) == 0
        assert not ckpt._PENDING
        assert torch.load(state, weights_only=True)["epoch"] == 1
        return
    if item is None:
        monkeypatch.setattr(jdevices, "enable_compilation_cache",
                            lambda: None)
        want = _record(monkeypatch, jpipelines, PIPELINES[command])
        got = _record(monkeypatch, pipelines, PIPELINES[command])
        argv = [command] + REQUIRED[command] + extra
        assert jcli.main(argv) == 0 and cli.main(argv) == 0
        for key in ("mesh_spec", "dist_spec"):
            g, w = got[key], want[key]
            assert (g is None) == (w is None), key
            if g is not None:
                fields = dataclasses.asdict(g)
                assert fields.pop("backend", None) is None
                assert fields == dataclasses.asdict(w), key
        assert (got["mesh_spec"], got["dist_spec"]) != (None, None) or \
            extra[0] == "--coordinator"
        return
    if command in PIPELINES:
        def never(**kw):
            raise AssertionError("the pipeline ran")

        monkeypatch.setattr(pipelines, PIPELINES[command], never)
    rc = cli.main([command] + REQUIRED.get(command, []) + extra)
    err = capsys.readouterr().err
    assert rc != 0
    assert "not ported yet" in err and item in err and "ROADMAP.md" in err


def test_usage_and_default_device_needs_the_card(tmp_path):
    """An unknown or missing subcommand prints the usage (exit 2); without
    ``--device cpu`` the pipelines ask for the card and raise without
    one."""
    assert cli.main(["nope"]) == 2 and cli.main([]) == 2
    with pytest.raises(SystemExit):
        cli.main(["inference", "--help"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["inference", "--data_dir", str(tmp_path), "--output_csv",
                  str(tmp_path / "o.csv"), "--allow_random_init", "--tiny"])
    for command in ("retrain", "train-scratch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command] + REQUIRED[command][:1] + [str(tmp_path),
                                                          "--tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["export-serving", "--output_dir", str(tmp_path / "a"),
                  "--allow_random_init", "--tiny"])


def test_selfcheck_is_offline_and_reports_failures(monkeypatch):
    """The self-check pins HF_HUB_OFFLINE and passes ``--device`` on; a
    crashing pipeline is a FAIL line and a non-zero exit, never a
    traceback."""
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    seen = {}

    def fake_infer(**kw):
        seen["offline"] = os.environ.get("HF_HUB_OFFLINE")
        seen["device"] = kw["device"]
        raise RuntimeError("inference boom")

    def fake_train(**kw):
        raise RuntimeError("training boom")

    monkeypatch.setattr(pipelines, "run_auv_inference", fake_infer)
    monkeypatch.setattr(pipelines, "run_AUV_training_from_scratch",
                        fake_train)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["selfcheck", "--device", "cpu"])
    out = buf.getvalue()
    assert rc == 1
    assert seen == {"offline": "1", "device": "cpu"}
    assert "FAIL inference pipeline ran" in out, out
    assert "FAIL training pipeline ran" in out, out
    assert "0/2 checks passed" in out, out
