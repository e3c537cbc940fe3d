"""Data-sharded DVP serving artifacts (multimodal_auv_torch/serving.py,
``mode="dvp"`` with ``data_shards``) and the two ops they add to
``auv::shard_sum``: ``auv::shard_gather`` and ``auv::shard_rows``
(parallel/local_shards.py).

The ops alone over 2 and 3 threads; the exported program's op nodes; the
data_shards=2 DVP artifact against the unsharded DVP artifact, with a
planted local-sums fault that the same gate rejects. Its bit-equality with
the DVP logits on the data=2 mesh of two gloo ranks, and the wrong-rows
fault that gate rejects, are in tests/test_torch_parallel.py (which
spawns those ranks once); the JAX package's own data-sharded DVP artifact
in tests/test_torch_serving_data_shards_jax.py. micro(), 32 px, b4 x 4
feature draws, every device "cpu"; each rendezvous has a timeout, so
nothing here can hang.
"""
import collections
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
    export_predict_artifact,
    load_predict_artifact,
)
from tests.test_torch_serving_data_shards import (
    LOGIT_RTOL,
    MASK,
    _batch,
    _rel,
    bn_layers,
)

B, PX, MC, C = 4, 32, 4, 3
TIMEOUT = 30  # seconds: a rendezvous that hangs fails the test


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the graphs are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_shards(n: int, fn, timeout: float = TIMEOUT) -> list:
    """``fn(d)`` as shard d of one group of ``n``, each on a thread of its
    own, in turns; returns [(result, error)] in shard order. A shard that
    raises aborts the group, as the loader's workers do."""
    group, turn = L.ShardGroup(n, timeout=timeout), L.Turn(timeout=timeout)
    out = [None] * n

    def shard(d):
        turn.take()
        try:
            with L.shard_context(group, d, turn):
                out[d] = (fn(d), None)
        except BaseException as e:  # noqa: BLE001 - returned to the test
            group.abort()
            out[d] = (None, e)
        finally:
            turn.give()

    threads = [threading.Thread(target=shard, args=(d,), daemon=True)
               for d in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * timeout)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_gather_and_rows_over_threads(n):
    """``auv::shard_gather``: every shard gets the shards' tensors
    concatenated along dimension 0 in shard order, on its own device, one
    rendezvous a call counted by shard 0. ``auv::shard_rows``: each shard's
    1/n slice along dimension 0 or 1, meeting no one (no rendezvous); a
    dimension that n does not divide raises."""
    x = torch.arange(n * 4 * 6, dtype=torch.float32).reshape(n * 4, 6)
    before = L.COUNTS["rendezvous"]

    def fn(d):
        mine = torch.full((2, 3), float(d))
        return (torch.ops.auv.shard_gather(mine, n),
                torch.ops.auv.shard_gather(mine[:1] + 10, n),
                torch.ops.auv.shard_rows(x, n, 0),
                torch.ops.auv.shard_rows(x.T.contiguous(), n, 1))

    out = _run_shards(n, fn)
    assert [e for _, e in out] == [None] * n
    want = torch.cat([torch.full((2, 3), float(d)) for d in range(n)])
    for d, ((g, g1, r0, r1), _) in enumerate(out):
        assert torch.equal(g, want)
        assert torch.equal(g1, torch.arange(n, dtype=torch.float32)
                           .repeat_interleave(3).reshape(n, 3) + 10)
        assert torch.equal(r0, x[4 * d:4 * (d + 1)])
        assert torch.equal(r1, x.T[:, 4 * d:4 * (d + 1)])
        assert r0.data_ptr() != x.data_ptr()  # a copy, not a view
    assert L.COUNTS["rendezvous"] == before + 2
    out = _run_shards(n, lambda d: torch.ops.auv.shard_rows(
        torch.ones(n + 1, 2), n, 0))
    assert all(isinstance(e, ValueError) for _, e in out)


def test_ops_refuse_outside_a_shard():
    """Neither op hands back the local tensor: outside a shard's worker,
    or in a group of another size, each raises (as ``auv::shard_sum``)."""
    x = torch.ones(4, 3)
    for op, args in (("shard_gather", ()), ("shard_rows", (0,))):
        call = getattr(torch.ops.auv, op)
        with pytest.raises(RuntimeError, match=f"auv::{op} outside a data "
                                               "shard"):
            call(x, 2, *args)
        with L.shard_context(L.ShardGroup(3), 0):
            with pytest.raises(RuntimeError, match=f"auv::{op} over 2 "
                                                   "shards in a group of 3"):
                call(x, 2, *args)


@pytest.mark.parametrize("n", [2, 3])
def test_failing_shard_raises_in_every_worker(n):
    """A shard that fails before its gather: every other shard's gather
    raises a broken barrier at once (the group aborted), not after the
    timeout; none returns a tensor."""
    def fn(d):
        if d == n - 1:
            raise RuntimeError("planted shard failure")
        return torch.ops.auv.shard_gather(torch.ones(2), n)

    t0 = time.perf_counter()
    out = _run_shards(n, fn, timeout=60)
    assert time.perf_counter() - t0 < 30
    assert all(r is None for r, _ in out)
    assert isinstance(out[-1][1], RuntimeError)
    assert all(isinstance(e, threading.BrokenBarrierError)
               for _, e in out[:-1])


@pytest.fixture(scope="module")
def bundle():
    return make_multimodal_bundle(C, BNNPriorSpec(),
                                  torch.Generator().manual_seed(0),
                                  ArchConfig.micro(), device="cpu")


@pytest.fixture(scope="module")
def arts(bundle, tmp_path_factory):
    """The unsharded DVP artifact of ``bundle`` and its data_shards=2 DVP
    artifact, loaded on CPU devices (the MOPED spread keeps DVP)."""
    kw = dict(batch_size=B, num_mc_samples=MC, image_size=PX, mode="dvp",
              seed=11)
    out = {}
    for name, n in (("one", 1), ("d2", 2)):
        d = str(tmp_path_factory.mktemp(name))
        export_predict_artifact(bundle, d, data_shards=n, **kw)
        out[name] = (d, load_predict_artifact(d, devices=["cpu"] * n))
    yield out
    for _, art in out.values():
        art.close()


def test_program_op_nodes(bundle, arts):
    """The data-sharded DVP program: one ``auv::shard_sum`` node per
    moment-BN ``sync_sums`` (two per BN layer: 54 at micro()), two
    ``auv::shard_gather`` (the feature means and variances), one
    ``auv::shard_rows`` and one split-sampler call (the whole batch's
    draws); meta.json has mode "dvp" and the shards; the loader serves it
    as one chunk of all the draws. A call meets 2 x 27 + 2 times."""
    d, art = arts["d2"]
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert (meta["mode"], meta["data_shards"], meta["mc_shards"]) == (
        "dvp", 2, 1)
    assert (art.mc_chunk, art.nchunks) == (MC, 1)
    ops = collections.Counter(
        str(n.target) for n in art._programs[art.device].graph.nodes
        if str(n.target).startswith("auv."))
    assert ops == {"auv.shard_sum.default": 2 * bn_layers(bundle),
                   "auv.shard_gather.default": 2,
                   "auv.shard_rows.default": 1,
                   "auv.split_sampler.default": 1}
    L.COUNTS["rendezvous"] = 0
    art.predict_logits(*_batch(2), key=2)
    assert L.COUNTS["rendezvous"] == 2 * bn_layers(bundle) + 2


def test_dvp_data_sharded_close_to_unsharded(arts, monkeypatch):
    """Two data shards against the unsharded DVP artifact at the same
    seeds, with and without a mask (which DVP does not read): the
    predicted classes equal, the logits within LOGIT_RTOL of the largest;
    ``predict`` gives the unsharded artifact's outputs to the same
    tolerance. With ``auv::shard_sum`` returning each shard's local sums
    (a planted fault) the same gate fails by at least 10x."""
    _, one = arts["one"]
    _, art = arts["d2"]
    for seed, mask in ((1, None), (2, MASK)):
        batch = _batch(seed)
        want = one.predict_logits(*batch, key=seed, mask=mask)
        got = art.predict_logits(*batch, key=seed, mask=mask)
        assert got.shape == (MC, B, C) and got.dtype == torch.float32
        assert _rel(got, want) <= LOGIT_RTOL, seed
        torch.testing.assert_close(art._reduce(got)[0], one._reduce(want)[0],
                                   rtol=0, atol=0)
    batch = _batch(3)
    got, want = art.predict(*batch, key=5), one.predict(*batch, key=5)
    np.testing.assert_array_equal(got["predicted"], want["predicted"])
    np.testing.assert_allclose(got["mean_prob"], want["mean_prob"], rtol=0,
                               atol=1e-6)
    monkeypatch.setattr(L.ShardGroup, "sum",
                        lambda self, index, x, turn=None: x.clone())
    batch = _batch(1)
    bad = art.predict_logits(*batch, key=1)
    assert _rel(bad, one.predict_logits(*batch, key=1)) >= 10 * LOGIT_RTOL


def test_dvp_failing_shard_raises_without_hanging(arts, monkeypatch):
    """A shard whose DVP program raises: the call raises that error at once
    (the other shard's rendezvous aborted, not waited out), and the next
    call is right."""
    _, art = arts["d2"]
    batch = _batch(4)
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
    monkeypatch.undo()
    torch.testing.assert_close(art.predict_logits(*batch, key=3), want,
                               rtol=0, atol=0)


def test_dvp_with_mc_shards_refused(bundle, tmp_path):
    """DVP with mc shards stays refused, as in the JAX package (the trunk
    pass has no draw axis to shard), with or without data shards."""
    for n in (1, 2):
        with pytest.raises(ValueError, match="mc_shards > 1 requires "
                                             "mode='mc'"):
            export_predict_artifact(bundle, str(tmp_path / "x"),
                                    batch_size=B, num_mc_samples=MC,
                                    image_size=PX, mode="dvp",
                                    data_shards=n, mc_shards=2)
    assert not os.path.exists(tmp_path / "x")
