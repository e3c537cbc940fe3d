"""The parts of the port's training path against the JAX package's: KL,
the running-statistics update, Adam with coupled L2, the NaN guard, the LR
schedule, the KL annealing, the split, the label encoding, the packed
batch order and the train-state checkpoint."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, kl_divergence
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.data.datasets import LabelEncoder, MultimodalFolderDataset
from multimodal_auv_torch.data.loaders import split_indices
from multimodal_auv_torch.data.packing import PackedTrainBatches
from multimodal_auv_torch.engine import checkpointing as ckpt
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    StepLR,
    kl_annealing_weight,
    make_optimizer,
    trainable_leaves,
)
from multimodal_auv_torch.engine.steps import make_train_step
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig, make_multimodal_bundle
from multimodal_auv_torch.models.resnet import batch_norm
from multimodal_auv_tpu.bayes import kl_divergence as jkl
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.data.datasets import MultimodalFolderDataset as JDataset
from multimodal_auv_tpu.data.loaders import split_indices as jsplit
from multimodal_auv_tpu.data.packing import PackedTrainBatches as JBatches
from multimodal_auv_tpu.engine.optim import StepLR as JStepLR
from multimodal_auv_tpu.engine.optim import kl_annealing_weight as jkl_weight
from multimodal_auv_tpu.engine.optim import make_optimizer as jmake_optimizer
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from tests.fixtures.make_tree import make_training_tree


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def bundles():
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.tiny())
    pb = from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                  _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                  [(e.path, e.shape, e.offset, e.size)
                   for e in jb.meta.entries],
                  num_classes=7, arch=ArchConfig.tiny(), device="cpu")
    return jb, pb


@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_kl_divergence_equals_jax(bundles, shift):
    """The MOPED posterior, and one moved off it, at rtol 1e-6 (f32 sums
    of 1.26M positive terms, in another order)."""
    jb, pb = bundles
    rng = np.random.default_rng(0)
    mu = (np.asarray(jb.post.mu) + shift * rng.standard_normal(
        pb.meta.n_padded)).astype(np.float32)
    rho = (np.asarray(jb.post.rho) + shift).astype(np.float32)
    spec = dict(prior_mu=0.1, prior_sigma=0.5) if shift else {}
    want = float(jkl(jb.post.replace(mu=jnp.asarray(mu),
                                     rho=jnp.asarray(rho)), JSpec(**spec)))
    got = float(kl_divergence(PackedPosterior(
        torch.from_numpy(mu), torch.from_numpy(rho), {}), BNNPriorSpec(**spec)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_running_stats_update_equals_flax(masked):
    """One BatchNorm's new running statistics equal flax's
    ``nn.BatchNorm(momentum=0.9)`` under ``mutable=["batch_stats"]``
    (biased variance over the mask's rows) at atol 1e-6, from running
    statistics that are not the init's; the port mutates nothing."""
    from flax import linen as nn

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    ra = {"mean": rng.standard_normal(16).astype(np.float32) * 0.1,
          "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    p = {"scale": rng.uniform(0.5, 2, 16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    mask = np.array([1, 1, 0], bool) if masked else None
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y_j, upd = bn.apply({"params": p, "batch_stats": ra}, jnp.asarray(x),
                        mask=None if mask is None
                        else jnp.asarray(mask).reshape(-1, 1, 1, 1),
                        mutable=["batch_stats"])
    stats = {k: torch.from_numpy(v.copy()) for k, v in ra.items()}
    y_t, new = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          stats, True,
                          None if mask is None else torch.from_numpy(mask),
                          torch.float32, mutable=True)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        assert torch.equal(stats[k], torch.from_numpy(ra[k]))
    rows = slice(0, 2) if masked else slice(None)
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).numpy()[rows],
                               np.asarray(y_j)[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_model_running_stats_equal_flax(bundles, masked):
    """Every BatchNorm's new statistics after one train-mode forward of the
    whole tiny() model equal flax's at atol 1e-5: the update itself agrees
    to 1e-6 (above), but each layer's batch variance E[x^2] - E[x]^2
    inherits the upstream layers' summation-order differences (forwards
    agree to rtol 1e-4, tests/test_torch_models.py). 64 px, so layer4
    keeps 2x2 positions."""
    jb, pb = bundles
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1 + 1.0).astype(
            np.float32), _np_tree(jb.batch_stats))
    w = np.asarray(jb.post.mu)
    x = [rng.standard_normal((3, 64, 64, c)).astype(np.float32)
         for c in (3, 3, 1)]
    mask = np.array([1, 1, 0], np.float32) if masked else None
    _, upd = jb.module.apply(
        {"params": jb.meta.unpack(jnp.asarray(w), jb.post.det),
         "batch_stats": stats}, *[jnp.asarray(a) for a in x], train=True,
        batch_mask=None if mask is None else jnp.asarray(mask),
        mutable=["batch_stats"])
    want = dict(_paths(_np_tree(upd["batch_stats"])))
    tstats = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                    stats)
    with torch.no_grad():
        _, new = pb.module(pb.meta.unpack(torch.from_numpy(w), pb.post.det),
                           tstats, *[torch.from_numpy(a) for a in x],
                           train=True,
                           batch_mask=None if mask is None
                           else torch.from_numpy(mask), mutable=True)
    got = dict(_paths(new))
    assert sorted(got) == sorted(want) and len(got) > 40
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_refresh_batch_stats_equals_jax(bundles, masked):
    """``refresh_batch_stats`` (one posterior-mean forward that advances
    the running statistics) equals the JAX package's at atol 1e-5, with
    and without a mask, and leaves its inputs unchanged."""
    from multimodal_auv_torch.engine.mc import refresh_batch_stats
    from multimodal_auv_tpu.engine.mc import refresh_batch_stats as jrefresh

    jb, pb = bundles
    rng = np.random.default_rng(5)
    x = [rng.standard_normal((3, 64, 64, c)).astype(np.float32)
         for c in (3, 3, 1)]
    mask = np.array([1, 1, 0], np.float32) if masked else None
    want = dict(_paths(_np_tree(jrefresh(
        jb.module, jb.meta, jb.post, jb.batch_stats,
        tuple(jnp.asarray(a) for a in x),
        batch_mask=None if mask is None else jnp.asarray(mask)))))
    before = {k: v.clone() for k, v in _paths(pb.batch_stats)}
    got = dict(_paths(refresh_batch_stats(
        pb.module, pb.meta, pb.post, pb.batch_stats,
        tuple(torch.from_numpy(a) for a in x),
        batch_mask=None if mask is None else torch.from_numpy(mask))))
    assert sorted(got) == sorted(want) and len(got) > 40
    for k, v in got.items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))
    for k, v in _paths(pb.batch_stats):
        assert torch.equal(v, before[k])


def test_adam_equals_optax_chain():
    """Three steps of the port's Adam (torch, coupled L2) and of the JAX
    package's optax chain, from the same posterior and gradients, with the
    decay on mu, rho and the BN affine: rtol 1e-6, atol 1e-4 * lr. optax
    forms the bias correction 1 - 0.999^t in f32, 4.7e-5 relative off the
    double torch uses, so each step's update differs by up to ~2.4e-5 * lr;
    the atol bounds three of them."""
    lr, wd = 1e-3, 1e-2
    rng = np.random.default_rng(2)
    post = {"mu": rng.standard_normal(2048).astype(np.float32),
            "rho": rng.standard_normal(2048).astype(np.float32) - 3.0,
            "det": {"bn": {"bias": rng.standard_normal(8).astype(np.float32),
                           "scale": rng.uniform(0.5, 2, 8).astype(
                               np.float32)}}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), post)
        for _ in range(3)]
    tx = jmake_optimizer(lr, wd)
    jp = jax.tree_util.tree_map(jnp.asarray, post)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = PackedPosterior(torch.tensor(post["mu"]), torch.tensor(post["rho"]),
                         jax.tree_util.tree_map(torch.tensor, post["det"]))
    opt = make_optimizer(lr, wd).init(tp)
    for g in grads:
        tg = [g["mu"], g["rho"]] + [v for _, v in _paths(g["det"])]
        for p, gi in zip(trainable_leaves(tp), tg):
            p.grad = torch.from_numpy(gi)
        opt.step()
    got = {"mu": tp.mu, "rho": tp.rho, **{
        k: v for k, v in _paths({"det": tp.det})}}
    want = {"mu": jp["mu"], "rho": jp["rho"], **{
        k: v for k, v in _paths({"det": jp["det"]})}}
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-4 * lr, err_msg=str(k))
    assert opt.state[tp.mu]["step"] == 3


def test_nan_guard_leaves_post_and_adam_unchanged():
    """A batch whose loss is NaN (a NaN pixel) updates neither the
    posterior nor the Adam state (moments and step count), still counts as
    a step, and reports skipped with a NaN loss."""
    b = make_multimodal_bundle(7, BNNPriorSpec(),
                               torch.Generator().manual_seed(0),
                               ArchConfig.micro(), device="cpu")
    state = BayesTrainState(b.post, make_optimizer(1e-3, 1e-5).init(b.post),
                            b.batch_stats)
    step = make_train_step(b.module, b.meta, BNNPriorSpec(), 2)
    rng = np.random.default_rng(3)
    x = [torch.from_numpy(rng.standard_normal((2, 32, 32, c)).astype(
        np.float32)) for c in (3, 3, 1)]
    labels, mask = torch.tensor([0, 3]), torch.ones(2)
    state, m = step(state, x, labels, mask, torch.Generator().manual_seed(1),
                    1e-6, 2.0)
    assert not m["skipped"] and np.isfinite(float(m["loss"]))
    leaves = [p.detach().clone() for p in trainable_leaves(state.post)]
    adam = {k: v.clone() for k, v in state.opt_state.state[b.post.mu].items()}
    x[0][1, 3, 4, 0] = float("nan")
    state, m = step(state, x, labels, mask, torch.Generator().manual_seed(2),
                    1e-6, 2.0)
    assert m["skipped"] and np.isnan(float(m["loss"]))
    assert float(m["fused"][5]) == 1.0 and state.step == 2
    assert all(torch.equal(p, q) for p, q in
               zip(trainable_leaves(state.post), leaves))
    after = state.opt_state.state[b.post.mu]
    assert all(torch.equal(after[k], v) for k, v in adam.items())
    assert int(after["step"]) == 1


def test_step_lr_double_step_and_kl_annealing():
    """StepLR stepped twice per epoch (the reference's quirk) gives the
    JAX package's LR sequence; the KL annealing weight equals JAX's."""
    ours, theirs = StepLR(1e-3, 7, 0.752), JStepLR(1e-3, 7, 0.752)
    lrs = []
    for _ in range(10):
        lrs.append(ours.lr)
        assert ours.lr == theirs.lr
        for s in (ours, theirs, ours, theirs):
            s.step()
    assert lrs[3] == 1e-3 and lrs[4] == pytest.approx(1e-3 * 0.752)
    assert lrs[7] == pytest.approx(1e-3 * 0.752 ** 2)
    ours.load_state_dict(theirs.state_dict())
    assert ours.epoch_count == 20
    for total in (1, 3, 20):
        for epoch in range(total):
            assert kl_annealing_weight(epoch, total) == jkl_weight(epoch,
                                                                   total)


def test_split_indices_equal_jax():
    for n in range(2, 61):
        train, test = split_indices(n)
        jtrain, jtest = jsplit(n)
        assert train == list(jtrain) and test == list(jtest), n


def test_label_encoding_equals_jax(tmp_path):
    """The port's LabelEncoder (sorted unique, searchsorted) gives the JAX
    dataset's sklearn codes, classes and paths on the same tree."""
    root = make_training_tree(str(tmp_path / "t"), n_samples=8,
                              labels=("Sand", "Kelp forest", "Mud", "Rock"))
    ours, theirs = MultimodalFolderDataset(root), JDataset(root)
    assert list(ours.label_encoder.classes_) == list(
        theirs.label_encoder.classes_)
    assert list(ours.labels) == list(theirs.labels)
    assert ours.data_paths == theirs.data_paths
    assert (ours.all_discovered_patch_sizes
            == theirs.all_discovered_patch_sizes)
    enc = LabelEncoder().fit(["b", "a", "c", "a"])
    assert list(enc.transform(["c", "a"])) == [2, 0]
    assert list(enc.inverse_transform([1])) == ["b"]
    with pytest.raises(ValueError):
        enc.transform(["d"])


def test_packed_train_batches_order_equals_jax():
    """Same seed, same epochs (counted and pinned): the same rows in the
    same batches."""
    n = 11
    packed = {"main": np.arange(n)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8),
        "bathy": np.zeros((n, 2, 2, 3), np.uint8),
        "sss": np.zeros((n, 2, 2, 1), np.uint8),
        "labels": np.arange(n, dtype=np.int32) % 3}
    idx = [7, 1, 3, 10, 0, 5, 2, 9]
    ours = PackedTrainBatches(packed, 3, idx, shuffle=True, seed=4)
    theirs = JBatches(packed, 3, idx, shuffle=True, seed=4)
    assert len(ours) == len(theirs) == 3
    for epoch in (None, None, 5):
        if epoch is not None:
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            assert all(np.array_equal(x[k], y[k]) for k in x)


def test_train_state_checkpoint_roundtrip(tmp_path):
    """save_train_state -> restore_train_state into a fresh template gives
    back the posterior, Adam state, statistics, step, epoch and scheduler
    counts; a file without scheduler metadata restores with None."""
    def fresh(seed):
        b = make_multimodal_bundle(7, BNNPriorSpec(),
                                   torch.Generator().manual_seed(seed),
                                   ArchConfig.micro(), device="cpu")
        return BayesTrainState(b.post, make_optimizer(1e-3).init(b.post),
                               b.batch_stats)

    state = fresh(0)
    for p in trainable_leaves(state.post):
        p.grad = torch.ones_like(p)
    state.opt_state.step()
    state.step = 5
    path = str(tmp_path / "s.pt")
    ckpt.save_train_state(path, state, 3, {"multimodal": 6})
    got, epoch, sched = ckpt.restore_train_state(path, fresh(1))
    assert (epoch, sched, got.step) == (3, {"multimodal": 6}, 5)
    for a, b in zip(trainable_leaves(got.post), trainable_leaves(state.post)):
        assert torch.equal(a, b)
    assert torch.equal(got.opt_state.state[got.post.mu]["exp_avg"],
                       state.opt_state.state[state.post.mu]["exp_avg"])
    d = torch.load(path, weights_only=True)
    del d["meta"]
    torch.save(d, path)
    assert ckpt.restore_train_state(path, fresh(1))[2] is None
    with pytest.raises(ValueError, match="shape"):
        other = make_multimodal_bundle(7, BNNPriorSpec(), None,
                                       ArchConfig.tiny(), device="cpu")
        ckpt.restore_train_state(path, BayesTrainState(
            other.post, make_optimizer().init(other.post),
            other.batch_stats))
