"""The port's CLI against the JAX package's: the same argv passes the same
keyword arguments to the pipelines (each monkeypatched to record them);
flags and subcommands of paths not ported yet exit non-zero naming their
ROADMAP item; the default ``--device cuda`` needs a card; the self-check
is offline and reports a crashing pipeline as a FAIL line."""
import io
import os
from contextlib import redirect_stdout

import pytest
import torch

import multimodal_auv_torch.pipelines as pipelines
import multimodal_auv_tpu.pipelines as jpipelines
import multimodal_auv_tpu.utils.devices as jdevices
from multimodal_auv_torch import cli
from multimodal_auv_tpu import cli as jcli

PIPELINES = {"inference": "run_auv_inference",
             "retrain": "run_auv_retraining",
             "train-scratch": "run_AUV_training_from_scratch"}
REQUIRED = {"inference": ["--data_dir", "/d", "--output_csv", "/o.csv"],
            "retrain": ["--data_dir", "/d"],
            "train-scratch": ["--root_dir", "/d"]}
TRAINING = ["--bathy_patch_base", "10", "--sss_patch_base", "20",
            "--mc_chunk", "2", "--bf16_weights", "--strict_errors",
            "--resume_checkpoint", "/ck", "--packed_loader", "--remat", "off",
            "--process_id", "0", "--dist_timeout", "9", "--tiny"]
SET_ALL = {
    "inference": ["--batch_size", "8", "--num_mc_samples", "3",
                  "--num_classes", "5", "--model_weights", "w.pt",
                  "--allow_random_init", "--mc_chunk", "2", "--packed_loader",
                  "--fast_sampling", "off", "--bn_mode", "eval", "--tiny"],
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
}


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


NOT_PORTED = [
    ("inference", ["--dvp"], "item 6"),
    ("retrain", ["--mesh_data", "2"], "item 8"),
    ("retrain", ["--mesh_mc", "2"], "item 8"),
    ("retrain", ["--fsdp"], "item 8"),
    ("retrain", ["--coordinator", "localhost:1"], "item 8"),
    ("retrain", ["--num_processes", "2"], "item 8"),
    ("retrain", ["--async_checkpoints"], "item 5"),
    ("retrain", ["--remat", "auto"], "item 5"),
    ("train-scratch", ["--fsdp"], "item 8"),
    ("train-scratch", ["--async_checkpoints"], "item 5"),
    ("train-scratch", ["--remat", "auto"], "item 5"),
    ("export-serving", [], "item 7"),
    ("data-prep", [], "item 9"),
]


@pytest.mark.parametrize("command,extra,item", NOT_PORTED,
                         ids=[f"{c}{''.join(e[:1])}" for c, e, _ in NOT_PORTED])
def test_unported_flags_exit_non_zero(monkeypatch, capsys, command, extra,
                                      item):
    """A flag or subcommand of a path not ported yet: a non-zero exit and a
    message naming its ROADMAP item; the pipeline never runs."""
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
