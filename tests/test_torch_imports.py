"""Import tripwire: the port and chip_smoke.py load no JAX and nothing of the
JAX package, and the entry points refuse to fall back to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_auv_tpu")
# absent on the machine with the card: never imported at module level
HOST_ONLY = ("sklearn", "PIL", "pandas", "matplotlib", "cv2")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import multimodal_auv_torch
names = [m.name for m in pkgutil.walk_packages(
    multimodal_auv_torch.__path__, "multimodal_auv_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in {forbidden!r})}}))
"""


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh process (this one has
    JAX loaded by the test configuration)."""
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(
            repo=REPO, forbidden=set(FORBIDDEN + HOST_ONLY))],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("engine.predict", "ops.sampling", "engine.steps",
                 "engine.optim", "engine.loops", "engine.checkpointing",
                 "engine.preemption", "engine.moment", "pipelines.training",
                 "utils.tb", "utils.plotting", "utils.manifest",
                 "utils.logging_utils",
                 "pipelines.unimodal", "models.model_utils",
                 "interop.from_jax", "interop.torch_import",
                 "interop.torch_export", "interop.hf_manifest", "interop.hub",
                 "cli", "selfcheck", "serving", "serve_http",
                 "serve_client", "models.fused", "parallel.mesh",
                 "parallel.distributed", "parallel.collectives",
                 "engine.mc", "bayes.packing", "engine.metrics",
                 "engine.uifm", "pipelines.noise_study", "pipelines.sweep",
                 "pipelines.preprocessing", "utils.profiling",
                 "utils.devices", "dataprep.geodesy", "dataprep.exif",
                 "dataprep.geotiff", "dataprep.optical", "dataprep.patches",
                 "dataprep.combine", "dataprep.qa", "dataprep.utilities",
                 "_lazy", "parallel.local_shards", "native"):
        assert f"multimodal_auv_torch.{name}" in out["modules"], name
    assert out["loaded"] == []


_EXPORTS_PROBE = r"""
import importlib, json, sys
sys.path.insert(0, {repo!r})
import multimodal_auv_torch
light = sorted(m for m in sys.modules if m.startswith("multimodal_auv_torch"))
names = []
for sub in ("", ".engine", ".bayes", ".ops", ".utils", ".parallel"):
    mod = importlib.import_module("multimodal_auv_torch" + sub)
    for name in mod.__all__:
        getattr(mod, name)
        names.append(sub + ":" + name)
from multimodal_auv_torch.ops import kernels
print(json.dumps({{"light": light, "names": names, "built": list(kernels._LIBS),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in {forbidden!r})}}))
"""


def test_package_exports_are_lazy_and_jax_free():
    """``import multimodal_auv_torch`` loads the package and its lazy-name
    helper alone (no model code, no kernel build); resolving every export
    of the package and of its engine, bayes, ops, utils and parallel
    subpackages then loads no JAX and nothing of the JAX package, and
    builds no kernel."""
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORTS_PROBE.format(
            repo=REPO, forbidden=set(FORBIDDEN + HOST_ONLY))],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["light"] == ["multimodal_auv_torch",
                            "multimodal_auv_torch._lazy"]
    assert ":run_auv_inference" in out["names"]
    assert ".engine:make_train_step" in out["names"] and len(out["names"]) > 35
    assert out["built"] == [] and out["loaded"] == []


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_import_anywhere_in_port_sources():
    """Imports inside functions too: every import statement of the port's
    sources and of chip_smoke.py. No sklearn or pandas anywhere, and cv2
    only in dataprep/optical.py (the ``CLAHE_CV2`` path, lazily)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "multimodal_auv_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = {p: r for p in paths for r in _imported_roots(p) if r in FORBIDDEN
           or r in ("sklearn", "pandas", "torchvision")}
    assert bad == {}
    cv2_users = sorted(os.path.relpath(p, REPO) for p in paths
                       if "cv2" in set(_imported_roots(p)))
    assert cv2_users == [os.path.join("multimodal_auv_torch", "dataprep",
                                      "optical.py")]
    assert len(paths) > 25


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        define_models,
        make_multimodal_bundle,
        make_unimodal_bundle,
    )
    from multimodal_auv_torch import serve_http
    from multimodal_auv_torch.pipelines.inference import (
        export_auv_serving_artifact,
        run_auv_inference,
    )
    from multimodal_auv_torch.pipelines.training import (
        run_AUV_training_from_scratch,
        run_auv_retraining,
    )
    from multimodal_auv_torch.pipelines.unimodal import run_unimodal_training

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multimodal_bundle(7, BNNPriorSpec(), None, ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_auv_inference(REPO, allow_random_init=True,
                          arch=ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_AUV_training_from_scratch({}, 1e-3, 1, 2, 10, 10, 2, REPO,
                                      arch=ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_auv_retraining(REPO, arch=ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        define_models(7, BNNPriorSpec(), None, ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_unimodal_bundle(1, 7, BNNPriorSpec(), None, ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_unimodal_training(REPO, "sss", arch=ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_auv_serving_artifact(os.path.join(REPO, "no_artifact"),
                                    allow_random_init=True,
                                    arch=ArchConfig.micro())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--artifact", os.path.join(REPO, "no_artifact")])
