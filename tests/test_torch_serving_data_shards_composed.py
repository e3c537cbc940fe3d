"""Data-sharded serving artifacts composed with mc shards
(multimodal_auv_torch/serving.py, ``data_shards`` x ``mc_shards``, on
data_shards x mc_shards devices, data shard d's mc shard m at index
d * mc_shards + m; the data shards alone:
tests/test_torch_serving_data_shards.py, whose gate and helpers this file
shares): the port's (2 data x 2 mc) artifact against its mc_shards=2
artifact and the one-process stacked path at the same seed. micro(), 32 px,
b4 x 4 MC, every device "cpu".
"""
import json
import os

import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.mc import mc_logits
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.parallel import local_shards as L
from multimodal_auv_torch.serving import (
    export_predict_artifact,
    load_predict_artifact,
)
from tests.test_torch_serving_data_shards import (
    LOGIT_RTOL,
    MASK,
    _batch,
    _op_nodes,
    _rel,
    bn_layers,
)

ARCH = ArchConfig.micro()
B, PX, MC, C = 4, 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the graphs are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """A random micro() bundle and its (2, 2) and mc_shards=2 artifacts
    (mc_chunk left at all the draws: one stack per chunk), loaded."""
    bundle = make_multimodal_bundle(C, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0), ARCH,
                                    device="cpu")
    out = {}
    for name, n, m in (("d2m2", 2, 2), ("m2", 1, 2)):
        d = str(tmp_path_factory.mktemp(name))
        export_predict_artifact(bundle, d, batch_size=B, num_mc_samples=MC,
                                image_size=PX, data_shards=n, mc_shards=m)
        out[name] = load_predict_artifact(d, devices=["cpu"] * (n * m))
    yield bundle, out
    for art in out.values():
        art.close()


def test_composed_against_mc_sharded_and_stacked(composed, monkeypatch):
    """Two data x two mc shards: the op once per BN layer inside the
    ``map`` body (one draw's graph) and none in the top graph; the logits
    against the mc_shards=2 artifact and the one-process stacked path
    (``mc_logits`` through ``gaussian_shift_scale``, one chunk of all
    draws, bf16 weights) at the same seed, within LOGIT_RTOL of the
    largest; both data shards of an mc column run its seed row, in
    ``seeds_for``'s order; the planted local-sums fault fails the gate by
    at least 10x."""
    bundle, arts = composed
    art, m2 = arts["d2m2"], arts["m2"]
    assert (art.data_shards, art.mc_shards, art.shard_rows, art.nchunks) == (
        2, 2, MC // 2, 1)
    assert _op_nodes(art._programs[art.device]) == [0, bn_layers(bundle)]
    batch = _batch(4)
    got = art.predict_logits(*batch, key=7, mask=MASK)
    assert got.shape == (MC, B, C)
    assert _rel(got, m2.predict_logits(*batch, key=7, mask=MASK)) <= LOGIT_RTOL
    with torch.inference_mode():
        stacked = mc_logits(bundle.module, bundle.meta, bundle.post,
                            bundle.batch_stats,
                            normalize_multimodal(*(torch.from_numpy(a)
                                                   for a in batch)),
                            torch.Generator().manual_seed(7), MC,
                            mc_chunk=MC, train=True, remat=False,
                            sample_dtype=torch.bfloat16,
                            batch_mask=torch.from_numpy(MASK))
    assert _rel(got, stacked) <= LOGIT_RTOL
    seen, real = [], art._programs[art.device]

    def spy(leaves, u8, seeds, mask):
        seen.append((L.current_shard()[1], tuple(seeds[0].tolist())))
        return real(leaves, u8, seeds, mask)

    monkeypatch.setitem(art._programs, art.device, spy)
    art.predict_logits(*batch, key=7, mask=MASK)
    rows = [tuple(r) for r in art.seeds_for(7).tolist()]
    assert len(rows) == 2
    for d in range(2):
        assert [s for i, s in seen if i == d] == rows
    monkeypatch.setitem(art._programs, art.device, real)
    monkeypatch.setattr(L.ShardGroup, "sum",
                        lambda self, index, x, turn=None: x.clone())
    bad = art.predict_logits(*batch, key=7)
    assert _rel(bad, m2.predict_logits(*batch, key=7)) >= 10 * LOGIT_RTOL


def test_composed_validation(composed, tmp_path):
    """The composed layout needs data_shards x mc_shards devices: a
    ``devices=`` list of the mc shards alone is refused (the loader checks
    the devices on meta.json, before it reads a program)."""
    _, arts = composed
    d = str(tmp_path / "a")
    os.makedirs(d)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({**arts["d2m2"].meta}, f)
    with pytest.raises(ValueError, match=r"one per mc shard of each data "
                                         r"shard \(2 x 2 = 4\), got 2"):
        load_predict_artifact(d, devices=["cpu"] * 2)
