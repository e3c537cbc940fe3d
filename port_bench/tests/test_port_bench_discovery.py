"""A configuration, a traffic mix, a limit file and a per-layer metric
added as new files (and entries in BENCHMARK.json) are found by name,
with no file of the benchmark edited."""
import hashlib
import json
import os
import shutil

from conftest import BENCH, ROOT


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(fh.read()).digest()
    return out


def test_new_cell_mix_and_metric_are_found_without_edits(tmp_path):
    from harness.spec import load_cell, reader

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("_cache", "_runs",
                                                  "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    bench = root / "port_bench"
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "unimodal_r50_bnn_sss.json")
                     .read_text())
    cfg.update(name="unimodal_r50_bnn_image", input_channels=3,
               modalities=[["image", 3]])
    (bench / "configs" / "unimodal_r50_bnn_image.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "unimodal_b128_mc10.json")
                     .read_text())
    mix.update(batch=64, modality="image", rate_metric="img_patches_per_s")
    (bench / "traffic" / "unimodal_b64_mc10.json").write_text(json.dumps(mix))
    (bench / "limits" / "img_predict_b64.json").write_text(
        json.dumps({"pu_gap": 0.5}))
    (bench / "metrics" / "batches_traced.py").write_text(
        "def read(run):\n    return float(run.batches)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                            "file": "port_bench/configs/"
                                    "unimodal_r50_bnn_image.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "img_predict_b64",
                              "config": cfg["name"],
                              "traffic": "unimodal_b64_mc10", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "img_patches_per_s",
                               "unit": "patches/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["img_predict_b64"]})
    spec["per_layer"].append({"name": "batches_traced.predict",
                              "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "engine",
                              "moves": "img_patches_per_s",
                              "workloads": ["img_predict_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell(str(root), "img_predict_b64", str(bench))
    assert cell.config["input_channels"] == 3
    assert cell.traffic["batch"] == 64
    assert cell.limits == {"pu_gap": 0.5}
    names = [m["name"] for m in cell.per_layer]
    assert "batches_traced.predict" in names
    assert "dispatch_ms.predict" not in names  # listed for other cells
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                   "img_patches_per_s"]

    class Run:
        batches = 3

    assert reader("batches_traced.predict", str(bench))(Run()) == 3.0
    # a metric name with suffixes falls back to its base reader
    assert reader("idle_share.anything", str(bench)) is not None
    assert reader("no_such_metric.predict", str(bench)) is None
    # nothing that was there changed
    after = _digests(bench)
    assert {k: after[k] for k in before} == before


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    from harness.spec import load_cell, reader

    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        assert reader(m["name"]) is not None, m["name"]
    for w in spec["workloads"]:
        cell = load_cell(ROOT, w["name"])
        assert cell.limits
        assert cell.traffic["rate_metric"] in {m["name"]
                                               for m in cell.end_to_end}
