"""mc-sharded serving artifacts (multimodal_auv_torch/serving.py,
``mc_shards``): kernel #2 as the forward-only op ``auv::stacked_sampler``
with device seeds, and the artifact whose M shards each draw num_mc / M
rows of the stacked path. The JAX side of this path is held under injected
eps elsewhere; here the port is held against its own one-process stacked
path bit for bit, because the artifact only reorders the same draws.
Validation follows tests/test_serving.py's mc-sharded cases.
"""
import json
import os
import shutil
import subprocess
import sys
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.mc import mc_logits
from multimodal_auv_torch.engine.predict import _mc_outputs
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import sampling as S
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.serving import (
    export_predict_artifact,
    load_predict_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = ArchConfig.micro()
B, PX, MC, C = 4, 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the graphs are tiny, and the suite's parallel
    workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    return make_multimodal_bundle(C, BNNPriorSpec(),
                                  torch.Generator().manual_seed(0), ARCH,
                                  device="cpu")


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, PX, PX, 1), dtype=np.uint8))


def _stacked_logits(bundle, batch, seed, mask, mc_chunk=MC):
    """The one-process stacked path: ``mc_logits`` through
    ``gaussian_shift_scale`` (f32 noise), bf16 weights, chunks of
    ``mc_chunk``, the seeds drawn from a generator seeded with ``seed``."""
    with torch.inference_mode():
        return mc_logits(bundle.module, bundle.meta, bundle.post,
                         bundle.batch_stats,
                         normalize_multimodal(*(torch.from_numpy(a)
                                                for a in batch)),
                         torch.Generator().manual_seed(seed), MC,
                         mc_chunk=mc_chunk, train=True, remat=False,
                         sample_dtype=torch.bfloat16,
                         batch_mask=torch.as_tensor(mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_sampler_op_is_the_stacked_forward(dtype):
    """``auv::stacked_sampler`` equals ``stacked_plain`` and the forward of
    ``gaussian_shift_scale`` bit for bit at the same seed words; with the
    words offset by ``draw_offset_seed`` it gives rows [m k, (m + 1) k) of
    the full stack; on the CPU it launches nothing."""
    P = S.BLOCK_ELEMS + 3 * S.LANES  # two blocks, the last one partial
    g = torch.Generator().manual_seed(3)
    mu = torch.randn(P, generator=g).to(dtype)
    sigma = (torch.rand(P, generator=g) * 0.1).to(dtype)
    seed = (0x12345678, 0xFFFFFFF0)  # seed1 wraps mod 2^32 over the draws
    before = dict(kernels.LAUNCHES)
    full = S.stacked_draws(mu, sigma, seed, 4, out_dtype=torch.bfloat16)
    assert kernels.LAUNCHES == before
    torch.testing.assert_close(
        full, S.stacked_plain(mu, sigma, seed, 4, torch.bfloat16),
        rtol=0, atol=0)
    with torch.no_grad():
        fwd = S.gaussian_shift_scale(mu, sigma, seed, 4,
                                     out_dtype=torch.bfloat16)
    torch.testing.assert_close(full, fwd, rtol=0, atol=0)
    k = 2
    for m in range(2):
        words = S.seed_tensor(S.draw_offset_seed(seed, m * k, P), "cpu")
        part = torch.ops.auv.stacked_sampler(mu, sigma, words, k,
                                             torch.bfloat16)
        torch.testing.assert_close(part, full[m * k:(m + 1) * k],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="seeds"):
        S.stacked_draws(mu, sigma, torch.zeros(3, dtype=torch.int64), 1)


def test_stacked_sampler_op_in_the_exported_graph():
    """``torch.export`` traces the op (its fake gives the shape), with the
    seed words a graph input; the exported module equals the eager op."""
    P = 2 * S.LANES

    class Draw(torch.nn.Module):
        def forward(self, mu, sigma, seeds):
            return S.stacked_draws(mu, sigma, seeds, 3)

    mu, sigma = torch.randn(P), torch.rand(P)
    seeds = S.seed_tensor((5, 6), "cpu")
    ep = torch.export.export(Draw(), (mu, sigma, seeds), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert "auv.stacked_sampler.default" in targets
    torch.testing.assert_close(ep.module()(mu, sigma, seeds),
                               S.stacked_plain(mu, sigma, (5, 6), 3,
                                               torch.float32),
                               rtol=0, atol=0)


class _FakeCard:
    """Stands in for ``torch.cuda.device`` and ``current_stream`` on a
    machine without a card: records which card is current at each call."""

    def __init__(self):
        self.current, self.seen = None, []

    def device(self, dev):
        card = self

        class Guard:
            def __enter__(self):
                self.prev, card.current = card.current, torch.device(dev)

            def __exit__(self, *exc):
                card.current = self.prev

        return Guard()

    def current_stream(self, dev):
        assert self.current == torch.device(dev), "stream of another card"
        return SimpleNamespace(cuda_stream=77)

    def launch(self, *args):
        self.seen.append((self.current, args[-1]))
        return 0


class _FakeTensor(SimpleNamespace):
    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0

    def new_empty(self, shape, dtype):
        return _FakeTensor(shape=shape, dtype=dtype, device=self.device)


@pytest.mark.parametrize("name", ["split_sampler", "stacked_sampler",
                                  "reparam_sampler", "eps"])
def test_launch_makes_the_tensors_card_current(monkeypatch, name):
    """Every launch runs with its tensors' card current and on that card's
    stream: an mc shard on cuda:1 launches #1-#4 from a process whose
    current card is cuda:0, and the ctypes call sets no device itself."""
    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setattr(torch.cuda, "current_stream", card.current_stream)
    monkeypatch.setattr(S, "_fn", lambda fn_name, argtypes: card.launch)
    dev = torch.device("cuda", 1)
    before = kernels.LAUNCHES[name]
    if name == "eps":
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda shape, dtype, device: (
            _FakeTensor(shape=shape, dtype=dtype, device=device)
            if torch.device(device).type == "cuda"
            else empty(shape, dtype=dtype, device=device)))
        S.launch_noise(name, 2 * S.LANES, (1, 2), 3, dev)
    else:
        mu = _FakeTensor(shape=(2 * S.LANES,), dtype=torch.float32,
                         device=dev)
        seed = (torch.zeros(2, dtype=torch.int64)
                if name != "reparam_sampler" else (1, 2))
        S._launch(name, mu, mu, seed, 3, torch.float32,
                  (0,) if name == "split_sampler" else ())
    assert card.seen == [(dev, 77)] and card.current is None
    assert kernels.LAUNCHES[name] == before + 1
    kernels.LAUNCHES[name] = before


def test_shard_devices_start_at_the_device(monkeypatch):
    """Without ``devices=``, M shards run on M consecutive cards from
    ``device``'s; too few cards from there is a ValueError; ``device=``
    beside ``devices=`` is refused (one of the two options)."""
    from multimodal_auv_torch import serving

    monkeypatch.setattr(serving, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert serving._shard_devices("cuda:1", None, 2) == cuda[1:3]
    assert serving._shard_devices("cuda:0", None, 4) == cuda
    assert serving._shard_devices("cuda:2", None, 1) == cuda[2:3]
    assert serving._shard_devices(None, ["cuda:3", "cuda:3"], 2) == [
        cuda[3], cuda[3]]
    with pytest.raises(ValueError, match="only 1 cuda devices are visible "
                                         "from cuda:3"):
        serving._shard_devices("cuda:3", None, 2)
    with pytest.raises(ValueError, match="not both"):
        serving._shard_devices("cuda:0", ["cuda:0", "cuda:1"], 2)


@pytest.fixture(scope="module")
def sharded(bundle, tmp_path_factory):
    """mc-sharded artifacts at M = 2 and M = 4 (mc_chunk left at its
    default: all the draws in one stack), loaded with M CPU devices."""
    out = {}
    for m in (2, 4):
        d = str(tmp_path_factory.mktemp(f"mc{m}"))
        export_predict_artifact(bundle, d, batch_size=B, num_mc_samples=MC,
                                image_size=PX, mc_shards=m, seed=11)
        out[m] = (d, load_predict_artifact(d, devices=["cpu"] * m))
    return out


@pytest.mark.parametrize("m", [2, 4])
def test_mc_sharded_artifact_bit_equal_to_stacked_path(bundle, sharded, m):
    """Each shard's program draws its rows of the one stack; the gathered
    logits equal the one-process stacked path's bit for bit at the same
    seed, and the CSV columns equal that path's estimators; the program
    calls ``auv::stacked_sampler`` and meta records the shards."""
    d, art = sharded[m]
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["mc_shards"] == m and meta["data_shards"] == 1
    assert meta["fast_sampling"] is False
    assert (art.mc_shards, art.mc_chunk, art.nchunks, art.shard_rows) == (
        m, MC, 1, MC // m)
    targets = {str(n.target) for p in art._programs.values()
               for n in p.graph.nodes if n.op == "call_function"}
    assert "auv.stacked_sampler.default" in targets
    assert "auv.split_sampler.default" not in targets
    batch = _batch(1)
    mask = np.array([1, 1, 1, 0], np.float32)
    ref = _stacked_logits(bundle, batch, 7, mask)
    got = art.predict_logits(*batch, key=7, mask=mask)
    assert got.shape == (MC, B, C)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    out = art.predict(*batch, key=7, mask=mask)
    want = _mc_outputs(ref)
    np.testing.assert_array_equal(out["csv_cols"],
                                  want["csv_cols"].numpy())
    np.testing.assert_array_equal(out["mean_prob"],
                                  want["mean_prob"].to(torch.float32).numpy())


def test_mc_sharded_program_file_and_torch_release(sharded):
    """The program keeps no source stack traces (each of a ``map`` body's
    nodes quoted the whole ``map`` call with its state operands: this
    file was 4.46 MB with them, 0.64 MB without); meta.json records the
    exporting torch, and a load under another release is refused by
    name."""
    d, _ = sharded[2]
    with zipfile.ZipFile(os.path.join(d, "program.pt2")) as z:
        model = z.read("program/models/model.json")
    assert b"stack_trace" not in model
    assert os.path.getsize(os.path.join(d, "program.pt2")) < 1.5e6
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["torch_version"] == torch.__version__
    other = os.path.join(d, "..", "other_torch")
    shutil.copytree(d, other)
    with open(os.path.join(other, "meta.json"), "w") as f:
        json.dump({**meta, "torch_version": "1.13.1+cu117"}, f)
    with pytest.raises(ValueError, match="exported with torch 1.13.1"):
        load_predict_artifact(other, devices=["cpu", "cpu"])


def test_mc_sharded_loader_needs_no_model_code(sharded):
    """An mc-sharded artifact loads and predicts in a process where the
    port's model, engine and posterior modules (and JAX) are never
    imported (an import tripwire), with the seeded outputs of the loader
    in this process."""
    d, art = sharded[2]
    batch = _batch(4)
    want = art.predict(*batch, key=5)["csv_cols"]
    code = f"""
import builtins, sys
_real = builtins.__import__
FORBIDDEN = ("jax", "multimodal_auv_tpu", "multimodal_auv_torch.models",
             "multimodal_auv_torch.engine", "multimodal_auv_torch.bayes")
def guard(name, *a, **k):
    if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
        raise ImportError("forbidden in serving process: " + name)
    return _real(name, *a, **k)
builtins.__import__ = guard
sys.path.insert(0, {REPO!r})
import numpy as np
import torch
torch.set_num_threads(1)
from multimodal_auv_torch.serving import load_predict_artifact
art = load_predict_artifact({d!r}, devices=["cpu", "cpu"])
rng = np.random.default_rng(4)
batch = [rng.integers(0, 255, ({B}, {PX}, {PX}, c), dtype=np.uint8)
         for c in (3, 3, 1)]
np.save(sys.argv[1], art.predict(*batch, key=5)["csv_cols"])
"""
    out = os.path.join(d, "sub.npy")
    proc = subprocess.run([sys.executable, "-c", code, out],
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(out), want)


def test_mc_sharded_chunks_and_stream(bundle, tmp_path):
    """mc_chunk < num_mc: chunk k's shard m draws rows [m k', (m + 1) k')
    of chunk k, so two chunks of two shards equal the stacked path in
    chunks of 2; ``predict_batches`` draws batch i from ``fold_seed(key,
    i)`` as the unsharded artifact does."""
    from multimodal_auv_torch.serving import fold_seed

    d = str(tmp_path / "a")
    export_predict_artifact(bundle, d, batch_size=B, num_mc_samples=MC,
                            image_size=PX, mc_shards=2, mc_chunk=2)
    art = load_predict_artifact(d, devices=["cpu", "cpu"])
    assert (art.mc_chunk, art.nchunks, art.shard_rows) == (2, 2, 1)
    assert art.seeds_for(5).shape == (4, 2)
    batches = [_batch(2), _batch(3)]
    ones = np.ones(B, np.float32)
    for i, (got, batch) in enumerate(zip(
            art.predict_batches(iter(batches), key=9), batches)):
        ref = _mc_outputs(_stacked_logits(bundle, batch, fold_seed(9, i),
                                          ones, mc_chunk=2))
        np.testing.assert_array_equal(got["csv_cols"],
                                      ref["csv_cols"].numpy())


def test_mc_sharded_validation(bundle, tmp_path):
    """The JAX package's four export errors (DVP, num_mc and mc_chunk not
    divisible by the shards, a polymorphic batch), ``data_shards`` > 1
    still refused naming ROADMAP item 8b at export, in the pipeline and at
    load, and the loader's device checks."""
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact

    x = str(tmp_path / "x")
    kw = dict(batch_size=B, num_mc_samples=MC, image_size=PX)
    with pytest.raises(ValueError, match="mode='mc'"):
        export_predict_artifact(bundle, x, **{**kw, "mode": "dvp"},
                                mc_shards=2)
    with pytest.raises(ValueError, match="divisible by mc_shards"):
        export_predict_artifact(bundle, x, **{**kw, "num_mc_samples": 5},
                                mc_shards=2)
    with pytest.raises(ValueError, match="mc_chunk 2 must be divisible by "
                                         "mc_shards 4"):
        export_predict_artifact(bundle, x, **kw, mc_shards=4, mc_chunk=2)
    with pytest.raises(ValueError, match="static batch_size"):
        export_predict_artifact(bundle, x, **{**kw, "batch_size": "poly"},
                                mc_shards=2)
    with pytest.raises(NotImplementedError, match="item 8b"):
        export_predict_artifact(bundle, x, **kw, data_shards=2)
    with pytest.raises(NotImplementedError, match="item 8b"):
        export_auv_serving_artifact(x, data_shards=2, device="cpu")
    assert not os.path.exists(x)

    d = str(tmp_path / "a")
    export_predict_artifact(bundle, d, **kw, mc_shards=2)
    with pytest.raises(ValueError, match="only 1 cpu devices are visible"):
        load_predict_artifact(d, device="cpu")
    with pytest.raises(ValueError, match="one per mc shard"):
        load_predict_artifact(d, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_predict_artifact(d, devices=["cuda:0", "cuda:0"])
    meta = json.load(open(os.path.join(d, "meta.json")))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({**meta, "data_shards": 2}, f)
    with pytest.raises(NotImplementedError, match="item 8b"):
        load_predict_artifact(d, devices=["cpu", "cpu"])
