"""The port's frozen-backbone retraining and pretrained inference against
the JAX package's: the freeze mask, the gated Adam against optax's chain
``add_decayed_weights -> freeze_transform -> scale_by_adam -> scale``,
``run_auv_retraining`` on a checkpoint the JAX package wrote, and
``run_auv_inference(model_weights_path=...)``.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.loaders import (
    prepare_inference_datasets_and_loaders,
)
from multimodal_auv_torch.engine.loops import EVAL_CSV_HEADER, TRAIN_CSV_HEADER
from multimodal_auv_torch.engine.optim import (
    make_backbone_freeze_mask,
    make_optimizer_with_freeze,
    trainable_leaves,
)
from multimodal_auv_torch.engine.predict import multimodal_predict_and_save
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint
from multimodal_auv_torch.interop.torch_import import (
    load_and_prepare_multimodal_model,
)
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.pipelines import run_auv_inference, run_auv_retraining
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.engine import optim as joptim
from multimodal_auv_tpu.interop.torch_export import (
    save_torch_checkpoint as jsave,
)
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from tests.fixtures.make_tree import make_inference_tree, make_training_tree

TRUNKS = ("image_model_feat", "bathy_model_feat", "sss_model_feat")
# optax forms Adam's bias correction 1 - 0.999^t in f32, 4.7e-5 relative
# off torch's double, so each step's update differs by up to ~2.4e-5 * lr
# (ROADMAP.md section 3); the tolerance bounds that many steps of it
ADAM_STEPS = 5
ADAM_ATOL_PER_LR = 2.4e-5 * ADAM_STEPS


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_freeze_mask_equals_jax():
    """1.0 on the fusion head's packed regions (attention_*, fc, fc1, fc2),
    0.0 on the trunks, the pad and every BatchNorm leaf, as JAX's."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=7, arch=ArchConfig.micro(), device="cpu")
    want = joptim.make_backbone_freeze_mask(jb.meta, jb.post)
    got = make_backbone_freeze_mask(pb.meta, pb.post)
    for name in ("mu", "rho"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert dict(_leaves(got.det)).keys() == dict(_leaves(want.det)).keys()
    assert all(not bool(v.any()) for _, v in _leaves(got.det))
    assert 0 < float(got.mu.sum()) < pb.meta.n_real
    for e in pb.meta.entries:
        head = not e.path[0].endswith("_model_feat")
        assert bool((got.mu[e.offset:e.offset + e.size] == head).all())
    assert not bool(got.mu[pb.meta.n_real:].any())


def test_gated_adam_equals_optax_chain():
    """Five steps of the port's gated Adam and of the JAX package's
    ``make_optimizer_with_freeze`` chain, from the same posterior and
    gradients, decay on: rtol 1e-6, atol 2.4e-5 * lr per step. Frozen
    elements (masked mu and rho, every det leaf) stay bit for bit unchanged
    and their Adam moments exactly zero."""
    lr, wd = 1e-3, 1e-2
    rng = np.random.default_rng(4)
    post = {"mu": rng.standard_normal(2048).astype(np.float32),
            "rho": rng.standard_normal(2048).astype(np.float32) - 3.0,
            "det": {"bn": {"bias": rng.standard_normal(8).astype(np.float32),
                           "scale": rng.uniform(0.5, 2, 8).astype(
                               np.float32)}}}
    flat = (np.arange(2048) % 3 == 0).astype(np.float32)
    mask = {"mu": flat, "rho": flat,
            "det": jax.tree_util.tree_map(np.zeros_like, post["det"])}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), post)
        for _ in range(ADAM_STEPS)]
    tx = joptim.make_optimizer_with_freeze(
        lr, wd, jax.tree_util.tree_map(jnp.asarray, mask))
    jp = jax.tree_util.tree_map(jnp.asarray, post)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    t = lambda tree: jax.tree_util.tree_map(torch.tensor, tree)
    tp = PackedPosterior(torch.tensor(post["mu"]), torch.tensor(post["rho"]),
                         t(post["det"]))
    tmask = PackedPosterior(torch.tensor(flat), torch.tensor(flat),
                            t(mask["det"]))
    opt = make_optimizer_with_freeze(lr, wd, tmask).init(tp)
    for g in grads:
        tg = [g["mu"], g["rho"]] + [v for _, v in _leaves(g["det"])]
        for p, gi in zip(trainable_leaves(tp), tg):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
    got = dict(_leaves({"mu": tp.mu, "rho": tp.rho, "det": tp.det}))
    want = dict(_leaves(_np_tree(jp)))
    before = dict(_leaves(post))
    masks = dict(_leaves(mask))
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=ADAM_ATOL_PER_LR * lr, err_msg=str(k))
        frozen = masks[k] == 0
        np.testing.assert_array_equal(g[frozen], before[k][frozen])
        assert np.all(g[~frozen] != before[k][~frozen]), k
    for p, m in zip(trainable_leaves(tp), trainable_leaves(tmask)):
        st = opt.state[p]
        for moment in ("exp_avg", "exp_avg_sq"):
            assert not bool(st[moment][m == 0].any())
    assert opt.state[tp.mu]["step"] == ADAM_STEPS


def test_retraining_from_a_jax_checkpoint(tmp_path, monkeypatch):
    """``run_auv_retraining`` on the CPU at micro() from a 7-class
    checkpoint written by the JAX package: 3 classes (the fc2 head
    swapped), frozen backbone, one epoch. It returns True and writes its
    ledgers; the trunks' mu and rho and every BatchNorm affine leaf equal
    the checkpoint's bit for bit, with zero Adam moments; the head moved;
    the running statistics still update."""
    micro = ArchConfig.micro()
    src = jmake(7, JSpec(), jax.random.PRNGKey(1), JArch.micro())
    ckpt = str(tmp_path / "foundation.pth")
    jsave(src, ckpt)
    monkeypatch.chdir(tmp_path)
    root = make_training_tree(str(tmp_path / "data"), n_samples=6,
                              labels=("Sand", "Mud", "Rock"))
    state_path = str(tmp_path / "state.pt")
    ok = run_auv_retraining(
        root_dir=root, num_classes=3, epochs_multimodal=1, num_mc=2,
        batch_size_multimodal=3, model_weights_path=ckpt, arch=micro,
        freeze_backbone=True, resume_checkpoint=state_path, device="cpu")
    assert ok is True
    for name, head in (("multimodal_train_results.csv", TRAIN_CSV_HEADER),
                       ("multimodal_eval_results.csv", EVAL_CSV_HEADER)):
        with open(os.path.join(root, "csvs", name), newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == head and len(rows) == 2
    st = torch.load(state_path, weights_only=True)["state"]
    dst = make_multimodal_bundle(3, BNNPriorSpec(),
                                 torch.Generator().manual_seed(0), micro,
                                 device="cpu")
    src_entries = {e.path: e for e in src.meta.entries}
    smu, srho = np.asarray(src.post.mu), np.asarray(src.post.rho)
    moments = st["opt_state"]["state"]
    moved = 0
    for e in dst.meta.entries:
        sl = slice(e.offset, e.offset + e.size)
        mu, rho = st["post"]["mu"][sl].numpy(), st["post"]["rho"][sl].numpy()
        if e.path[0] in TRUNKS:
            s = src_entries[e.path]
            ssl = slice(s.offset, s.offset + s.size)
            np.testing.assert_array_equal(mu, smu[ssl], err_msg=str(e.path))
            np.testing.assert_array_equal(rho, srho[ssl], err_msg=str(e.path))
            for i in (0, 1):  # mu, rho
                for m in ("exp_avg", "exp_avg_sq"):
                    assert not bool(moments[i][m][sl].any()), e.path
        elif e.path[0] != "fc2":
            s = src_entries[e.path]
            moved += not np.array_equal(mu, smu[s.offset:s.offset + s.size])
    assert moved > 10
    for i, (k, v) in enumerate(_leaves(_np_tree(src.post.det)), start=2):
        got = st["post"]["det"]
        for p in k:
            got = got[p]
        np.testing.assert_array_equal(got.numpy(), v, err_msg=str(k))
        assert not bool(moments[i]["exp_avg"].any())
    var = lambda bs: np.asarray(bs["image_model_feat"]["bn1"]["var"])
    assert not np.array_equal(var(st["batch_stats"]), var(src.batch_stats))


@pytest.mark.parametrize("published", [False, True],
                         ids=["export", "published"])
def test_inference_with_model_weights_path(tmp_path, published):
    """``run_auv_inference(model_weights_path=...)`` at micro(): its CSV is
    byte-equal to the same run on a bundle imported directly."""
    micro = ArchConfig.micro()
    src = make_multimodal_bundle(7, BNNPriorSpec(),
                                 torch.Generator().manual_seed(5), micro,
                                 device="cpu")
    src.post.mu += 0.01 * (torch.arange(src.post.mu.numel()) % 7)
    path = str(tmp_path / "pytorch_model.bin")
    save_torch_checkpoint(src, path, published=published)
    root = make_inference_tree(str(tmp_path / "dives"), n_samples=3)
    out = str(tmp_path / "pipeline.csv")
    run_auv_inference(root, batch_size=2, output_csv=out, num_mc_samples=2,
                      model_weights_path=path, arch=micro, device="cpu")
    b = make_multimodal_bundle(7, BNNPriorSpec(),
                               torch.Generator().manual_seed(123), micro,
                               device="cpu")
    b, stats = load_and_prepare_multimodal_model(b, path)
    assert stats["dropped"] == 0 and stats["missing"] == []
    direct = str(tmp_path / "direct.csv")
    multimodal_predict_and_save(
        b, prepare_inference_datasets_and_loaders([root], 2, image_size=32),
        direct, 2, generator=torch.Generator().manual_seed(1), device="cpu")
    with open(out, "rb") as f, open(direct, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and got.count(b"\n") == 4
