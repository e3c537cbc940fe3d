"""Data-sharded serving artifacts (multimodal_auv_torch/serving.py,
``data_shards``): one data shard's program, whose BatchNorm sums go through
the op ``auv::shard_sum`` (parallel/local_shards.py), run by one loader
thread per data shard, alone and composed with ``mc_shards``.

The port's artifact is held against its own unsharded artifact here (the
BN sums of N shards add the same numbers in another order), against the
data=2 mesh step bit for bit in tests/test_torch_parallel.py (which reuses
that file's two gloo ranks), and, composed with mc shards, against the
mc-sharded artifact and the JAX package's own sharded artifacts in
tests/test_torch_serving_data_shards_jax.py (the exports are what takes
the time: two files keep each of the suite's workers short). micro(),
32 px, b4 x 4 MC, every device "cpu"; each rendezvous has a timeout, so
nothing here can hang.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.parallel import local_shards as L
from multimodal_auv_torch.serving import (
    _tree_leaves,
    export_predict_artifact,
    load_predict_artifact,
)

ARCH = ArchConfig.micro()
B, PX, MC, C = 4, 32, 4, 3
# logits against the unsharded (or mc-sharded) artifact, relative to the
# largest |logit|: the BN sums of the shards add the same terms in another
# order (1.3e-6 at most over 4 batches at N = 2 and 4); a shard that kept
# its local sums (the planted fault) is off by 0.12-0.24 of it
LOGIT_RTOL = 1e-5
MASK = np.array([1, 1, 1, 0], np.float32)


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


@pytest.fixture(scope="module")
def arts(bundle, tmp_path_factory):
    """Loaded artifacts of ``bundle``, one draw a chunk (one forward per
    program): "one" unsharded, "d2" and "d4" data shards. "d2" comes
    through the pipeline (random init from seed 0: ``bundle``)."""
    from multimodal_auv_torch.pipelines import export_auv_serving_artifact

    kw = dict(batch_size=B, num_mc_samples=MC, image_size=PX, mc_chunk=1)
    out = {}
    for name, n, extra in (("one", 1, {}), ("d4", 4, dict(data_shards=4))):
        d = str(tmp_path_factory.mktemp(name))
        export_predict_artifact(bundle, d, **kw, **extra, seed=11)
        out[name] = (d, load_predict_artifact(d, devices=["cpu"] * n))
    d = str(tmp_path_factory.mktemp("d2"))
    old = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        export_auv_serving_artifact(d, batch_size=B, num_mc_samples=MC,
                                    num_classes=C, allow_random_init=True,
                                    arch=ARCH, mc_chunk=1, data_shards=2,
                                    device="cpu")
    finally:
        if old is None:
            del os.environ["HF_HUB_OFFLINE"]
        else:
            os.environ["HF_HUB_OFFLINE"] = old
    out["d2"] = (d, load_predict_artifact(d, devices=["cpu", "cpu"]))
    yield out
    for _, art in out.values():
        art.close()


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 255, (n, PX, PX, 1), dtype=np.uint8))


def _rel(got, want) -> float:
    """max |got - want| relative to the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _op_nodes(module) -> list:
    """(graph, number of auv::shard_sum nodes) of each graph of an
    exported program's module, the ``map`` body's included."""
    return [sum(str(n.target) == "auv.shard_sum.default"
                for n in gm.graph.nodes)
            for gm in module.modules() if isinstance(gm, torch.fx.GraphModule)]


def bn_layers(bundle) -> int:
    """The model's BatchNorm layers: one affine scale each."""
    return sum(p[-1] == "scale" for p, _ in _tree_leaves(bundle.post.det))


def test_program_holds_one_op_per_bn_layer(bundle, arts, tmp_path):
    """The chunk program calls ``auv::shard_sum`` once per BN layer of its
    one draw (27 at micro(): the three trunks); meta.json records the
    shards; the unsharded program and an eval-mode BN export hold no op
    (no batch statistics)."""
    layers = bn_layers(bundle)
    assert layers == 27
    for name, n in (("d2", 2), ("d4", 4)):
        d, art = arts[name]
        meta = json.load(open(os.path.join(d, "meta.json")))
        assert (meta["data_shards"], meta["mc_shards"]) == (n, 1)
        assert (art.data_shards, art.mc_shards) == (n, 1)
        assert _op_nodes(art._programs[art.device]) == [layers], name
    assert _op_nodes(arts["one"][1]._programs[torch.device("cpu")]) == [0]
    e = str(tmp_path / "eval")
    export_predict_artifact(bundle, e, batch_size=B, num_mc_samples=MC,
                            image_size=PX, mc_chunk=1, data_shards=2,
                            bn_mode="eval")
    art = load_predict_artifact(e, devices=["cpu", "cpu"])
    try:
        assert _op_nodes(art._programs[art.device]) == [0]
        assert art.predict_logits(*_batch(3), key=1).shape == (MC, B, C)
    finally:
        art.close()


@pytest.mark.parametrize("n", [2, 4])
def test_data_sharded_close_to_unsharded(arts, monkeypatch, n):
    """N data shards against the unsharded artifact at the same seeds, all
    rows and one masked out: the predicted classes equal, the logits
    within LOGIT_RTOL of the largest; with ``auv::shard_sum`` returning
    each shard's local sums (a planted fault) the same gate fails by at
    least 10x."""
    _, one = arts["one"]
    _, art = arts[f"d{n}"]
    assert art.mc_chunk == 1 and art.nchunks == MC
    for seed, mask in ((1, None), (2, MASK)):
        batch = _batch(seed)
        want = one.predict_logits(*batch, key=seed, mask=mask)
        got = art.predict_logits(*batch, key=seed, mask=mask)
        assert got.shape == (MC, B, C)
        assert _rel(got, want) <= LOGIT_RTOL, (n, seed)
        # the artifacts' reduction programs: row 0 is the predicted class
        torch.testing.assert_close(art._reduce(got)[0], one._reduce(want)[0],
                                   rtol=0, atol=0)
    monkeypatch.setattr(L.ShardGroup, "sum",
                        lambda self, index, x, turn=None: x.clone())
    batch = _batch(1)
    bad = art.predict_logits(*batch, key=1)
    assert _rel(bad, one.predict_logits(*batch, key=1)) >= 10 * LOGIT_RTOL


def test_data_sharded_validation(bundle, arts, tmp_path):
    """JAX's export errors (a polymorphic batch; a batch not divisible by
    the data shards), before anything is written; the DVP program with
    data shards (ROADMAP item 8c, ported) exports and loads on two CPU
    shards as one chunk of all the draws; the loader's device count
    (shards from ``device``'s visible devices) and ``devices=`` length
    errors."""
    x = str(tmp_path / "x")
    kw = dict(num_mc_samples=MC, image_size=PX)
    with pytest.raises(ValueError, match="static batch_size"):
        export_predict_artifact(bundle, x, batch_size="poly", **kw,
                                data_shards=2)
    with pytest.raises(ValueError, match="batch_size 4 must be divisible "
                                         "by data_shards 3"):
        export_predict_artifact(bundle, x, batch_size=B, **kw, data_shards=3)
    assert not os.path.exists(x)
    dvp = str(tmp_path / "dvp")
    export_predict_artifact(bundle, dvp, batch_size=B, **kw, mode="dvp",
                            dvp_on_excess="warn", data_shards=2)
    art = load_predict_artifact(dvp, devices=["cpu", "cpu"])
    try:
        assert (art.meta["mode"], art.data_shards, art.mc_chunk,
                art.nchunks) == ("dvp", 2, MC, 1)
    finally:
        art.close()
    d, _ = arts["d2"]
    with pytest.raises(ValueError, match=r"2 x 1 \(data x mc\) shards but "
                                         "only 1 cpu devices are visible"):
        load_predict_artifact(d, device="cpu")
    with pytest.raises(ValueError, match=r"one per mc shard of each data "
                                         r"shard \(2 x 1 = 2\), got 3"):
        load_predict_artifact(d, devices=["cpu"] * 3)


def test_op_refuses_outside_a_shard():
    """``auv::shard_sum`` never returns the local sums: outside a shard's
    worker, or in a group of another size, it raises."""
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="outside a data shard"):
        torch.ops.auv.shard_sum(x, 2)
    with L.shard_context(L.ShardGroup(3), 0):
        with pytest.raises(RuntimeError, match="over 2 shards in a group "
                                               "of 3"):
            torch.ops.auv.shard_sum(x, 2)


def test_failing_shard_raises_without_hanging(arts, monkeypatch):
    """A shard whose program raises: the call raises that error at once
    (the other shard's barrier is aborted, not waited out); a shard that
    stalls past the rendezvous timeout: the call raises a broken barrier
    (or the other shard's timeout waiting for its turn) after the timeout. The workers survive both, and the next call is
    right; ``close`` stops them and a later call starts them again."""
    d, art = arts["d2"]
    batch = _batch(5)
    want = art.predict_logits(*batch, key=3)
    real = art._programs[art.device]

    def failing(*a):
        if L.current_shard()[1] == 1:
            raise RuntimeError("planted shard failure")
        return real(*a)

    monkeypatch.setitem(art._programs, art.device, failing)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="planted shard failure"):
        art.predict_logits(*batch, key=3)
    assert time.perf_counter() - t0 < 30

    release = threading.Event()

    def stalling(*a):
        if L.current_shard()[1] == 1:
            release.wait(timeout=2)
        return real(*a)

    monkeypatch.setitem(art._programs, art.device, stalling)
    monkeypatch.setattr(art, "shard_timeout", 0.5)
    t0 = time.perf_counter()
    # the other shard times out at a barrier, or waiting for its turn
    with pytest.raises((threading.BrokenBarrierError, TimeoutError)):
        art.predict_logits(*batch, key=3)
    assert time.perf_counter() - t0 < 30
    monkeypatch.setitem(art._programs, art.device, real)
    monkeypatch.undo()
    torch.testing.assert_close(art.predict_logits(*batch, key=3), want,
                               rtol=0, atol=0)
    art.close()
    assert art._workers is None
    torch.testing.assert_close(art.predict_logits(*batch, key=3), want,
                               rtol=0, atol=0)


def test_rendezvous_and_launch_counts_under_thread_stress():
    """More shard threads than cores, a shortened switch interval: every
    shard's every ``auv::shard_sum`` returns the exact sum of the round's
    inputs and every ``auv::shard_gather`` the round's inputs in shard
    order (a slot read after the next round's write breaks them), the
    threads take turns, and ``kernels.count`` from all of them loses no
    launch; each thread joins within its timeout."""
    import sys

    from multimodal_auv_torch.ops import kernels

    n, rounds, counts = 16, 40, 2000
    group, turn = L.ShardGroup(n, timeout=60), L.Turn(timeout=60)
    start = threading.Barrier(n, timeout=60)
    wrong, errors = [], []
    before = kernels.LAUNCHES["noise_parts"]

    def shard(d):
        try:
            start.wait()
            for _ in range(counts):  # every thread at once
                kernels.count("noise_parts")
            turn.take()
            with L.shard_context(group, d, turn):
                for r in range(rounds):
                    got = torch.ops.auv.shard_sum(
                        torch.full((3,), float(r * n + d)), n)
                    want = sum(r * n + i for i in range(n))
                    if not torch.equal(got, torch.full((3,), float(want))):
                        wrong.append((d, r, got))
                    got = torch.ops.auv.shard_gather(
                        torch.full((1,), float(r * n + d)), n)
                    if not torch.equal(got, torch.arange(
                            r * n, (r + 1) * n, dtype=torch.float32)):
                        wrong.append((d, r, got))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            group.abort()
        finally:
            turn.give()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=shard, args=(d,), daemon=True)
                   for d in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and wrong == []
    assert kernels.LAUNCHES["noise_parts"] == before + counts * n
    kernels.LAUNCHES["noise_parts"] = before
