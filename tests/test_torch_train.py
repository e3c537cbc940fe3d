"""The port's training path as a whole against the JAX package's.

One step: the JAX ``make_train_step`` (impl="jnp", packed inputs) and the
port's, on the same weights (carried by interop/from_jax.py) and the same
eps. The TPU's noise cannot be reproduced, so the port's one plain eps
function is replaced, in this test only, by one returning
``jax.random.normal(chunk_key, (mc_chunk, P))``, where ``chunk_key`` is the
JAX chunk key of the same step and chunk. The replacement is keyed on the
chunk's seed, because the port draws eps in the forward, in the
checkpoint's re-forward and in the backward.

One epoch: ``run_AUV_training_from_scratch`` over a synthetic survey tree,
on the CPU, with the real (plain-version) sampler.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.ops.sampling as torch_sampling
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine import checkpointing as ckpt
from multimodal_auv_torch.engine.loops import EVAL_CSV_HEADER, TRAIN_CSV_HEADER
from multimodal_auv_torch.engine.mc import chunk_seeds
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.engine.steps import make_train_step
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.engine.optim import BayesTrainState as JState
from multimodal_auv_tpu.engine.optim import make_optimizer as jmake_optimizer
from multimodal_auv_tpu.engine.steps import make_elbo_loss_fn as jelbo
from multimodal_auv_tpu.engine.steps import make_train_step as jmake_train_step
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from multimodal_auv_torch.pipelines.training import run_AUV_training_from_scratch
from tests.fixtures.make_tree import make_training_tree

NUM_MC = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _port_bundle(jb):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    _np_tree(jb.post.det), _np_tree(jb.batch_stats),
                    [(e.path, e.shape, e.offset, e.size)
                     for e in jb.meta.entries],
                    num_classes=7, arch=ArchConfig.micro(), device="cpu")


def _assert_leaf_close(got, want, name, rtol, floor_frac=1e-3):
    """tests/test_train_parity.py's criterion: elementwise rtol with a
    leaf-scaled floor (entries below floor_frac * max|want| are noise
    relative to the update they drive)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor_frac * scale,
                               err_msg=f"gradient mismatch at {name}")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX bundle, its jitted train step and the gradient of the loss
    it differentiates, built once (compiling them dominates this file)."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    tx = jmake_optimizer(1e-3, 1e-5)
    jstep = jmake_train_step(jb.module, jb.meta, JSpec(), tx, NUM_MC,
                             impl="jnp", packed_inputs=True)
    grad_fn = jax.jit(jax.value_and_grad(
        jelbo(jb.module, jb.meta, JSpec(), NUM_MC, impl="jnp",
              packed_inputs=True), has_aux=True))
    return jb, tx, jstep, grad_fn


@pytest.mark.parametrize("kl_weight", [0.0, 1e-6])
def test_one_train_step_equals_jax(monkeypatch, jax_side, kl_weight):
    """Batch 3 with a ragged tail (mask [1, 1, 0]), 32 px uint8 inputs,
    3 draws in chunks of 1, remat on, chained BN. Loss, CE and scaled KL
    agree to rtol 1e-4 (f32 forwards; reductions in another order); every
    mu, rho and BN-affine gradient to rtol 2e-2 with the leaf-scaled
    floor; the chained running statistics to atol 1e-5; the pad gets no
    gradient. kl_weight 0 isolates the MC and CE path; 1e-6 puts the KL
    at the CE's magnitude."""
    jb, tx, jstep, grad_fn = jax_side
    pb = _port_bundle(jb)
    P = pb.meta.n_padded
    rng = np.random.default_rng(5)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    labels = np.array([1, 4, 4], np.int32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(42)

    # the JAX chunk keys of this step, by the port's chunk seed
    seeds = chunk_seeds(torch.Generator().manual_seed(9), NUM_MC)
    chunk_keys = dict(zip(seeds, jax.random.split(key, NUM_MC)))
    calls = []

    def jax_eps(P_, seed, num_draws, device=None, noise="f32"):
        assert noise == "f32" and P_ == P
        calls.append(tuple(seed))
        eps = jax.random.normal(chunk_keys[tuple(seed)], (num_draws, P_),
                                jnp.float32)
        return torch.from_numpy(np.array(eps)).to(device)

    monkeypatch.setattr(torch_sampling, "eps_plain", jax_eps)

    jstate = JState(post=jb.post, opt_state=tx.init(jb.post),
                    batch_stats=jb.batch_stats,
                    step=jnp.zeros((), jnp.int32))
    jin = tuple(jnp.asarray(a) for a in u8)
    jstate2, jm = jstep(jstate, jin, jnp.asarray(labels), jnp.asarray(mask),
                        key, kl_weight, 3.0)
    # the gradients that step applied, from the function it differentiates
    _, jgrads = grad_fn(jb.post, jb.batch_stats, jin, jnp.asarray(labels),
                        jnp.asarray(mask), key, jnp.float32(kl_weight),
                        jnp.float32(3.0))

    state = BayesTrainState(pb.post, make_optimizer(1e-3, 1e-5).init(pb.post),
                            pb.batch_stats)
    step = make_train_step(pb.module, pb.meta, BNNPriorSpec(), NUM_MC,
                           packed_inputs=True)
    state, m = step(state, [torch.from_numpy(a) for a in u8],
                    torch.from_numpy(labels), torch.from_numpy(mask),
                    torch.Generator().manual_seed(9), kl_weight, 3.0)

    # forward, re-forward and backward of each chunk drew eps by its seed
    assert sorted(calls) == sorted(seeds * 3)
    assert state.step == 1 and not m["skipped"]
    for name in ("loss", "cross_entropy", "scaled_kl"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    assert float(m["correct"]) == float(jm["correct"])
    np.testing.assert_array_equal(m["predicted"].numpy(),
                                  np.asarray(jm["predicted"]))

    gmu, grho = pb.post.mu.grad.numpy(), pb.post.rho.grad.numpy()
    jmu, jrho = np.asarray(jgrads.mu), np.asarray(jgrads.rho)
    for e in pb.meta.entries:
        sl = slice(e.offset, e.offset + e.size)
        _assert_leaf_close(gmu[sl], jmu[sl], f"dmu{e.path}", rtol=2e-2)
        _assert_leaf_close(grho[sl], jrho[sl], f"drho{e.path}", rtol=2e-2)
    n_real = pb.meta.n_real
    assert not np.any(gmu[n_real:]) and not np.any(grho[n_real:])
    jdet = dict(_leaves_with_paths(_np_tree(jgrads.det)))
    tdet = dict(_leaves_with_paths(pb.post.det))
    assert sorted(jdet) == sorted(tdet) and len(tdet) > 20
    for path, leaf in tdet.items():
        _assert_leaf_close(leaf.grad.numpy(), jdet[path], f"ddet{path}",
                           rtol=2e-2)

    jbs = dict(_leaves_with_paths(_np_tree(jstate2.batch_stats)))
    tbs = dict(_leaves_with_paths(state.batch_stats))
    assert sorted(jbs) == sorted(tbs)
    for path, leaf in tbs.items():
        np.testing.assert_allclose(leaf.numpy(), jbs[path], rtol=0,
                                   atol=1e-5, err_msg=str(path))
    # the statistics really moved: one momentum step per draw
    moved = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jbs.values(), dict(_leaves_with_paths(
            _np_tree(jb.batch_stats))).values()))
    assert moved > 1e-3


# the JAX package's ledger headers (engine/loops.py:194-196, :300-304)
JAX_TRAIN_HEADER = ["Epoch", "Model type", "Loss", "Accuracy", "lr",
                    "kl loss", "cross entropy loss", "SSS Patch Type",
                    "Channel Patch Type"]
JAX_EVAL_HEADER = ["Epoch", "Model Type", "Test Loss", "Test Accuracy",
                   "Predictive Uncertainty", "Model Uncertainty", "Scaled KL",
                   "Cross Entropy Loss", "bathy Patch Type", "SSS Patch Type"]


class _StopAtCheck:
    """A preemption guard that triggers at its n-th poll (the train loop
    polls once before each batch)."""

    def __init__(self, n):
        self.n, self.polls, self.triggered = n, 0, False

    def check(self):
        self.polls += 1
        self.triggered = self.triggered or self.polls >= self.n
        return self.triggered


def _train(root, ckpt_path, *, packed=True, epochs=2, **kw):
    return run_AUV_training_from_scratch(
        {}, 1e-3, epochs, 2, 10, 10, 2, root, arch=ArchConfig.micro(),
        use_packed_loader=packed, resume_checkpoint=ckpt_path,
        handle_preemption=False, device="cpu", **kw)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("packed", [False, True], ids=["folders", "packed"])
def test_training_from_scratch_cpu(tmp_path, monkeypatch, packed):
    """Two epochs of the whole pipeline over 6 synthetic samples (4 train
    in batches of 2, 2 eval), 2 MC draws: True, both ledgers with the JAX
    headers and one row per epoch of finite numbers, the posterior
    checkpoint on the reference's path, and a resumable train state."""
    monkeypatch.chdir(tmp_path)  # the pipeline logs under ./logs
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    state_path = str(tmp_path / "state.pt")
    assert _train(root, state_path, packed=packed)
    assert TRAIN_CSV_HEADER == JAX_TRAIN_HEADER
    assert EVAL_CSV_HEADER == JAX_EVAL_HEADER
    for name, head in (("multimodal_train_results.csv", JAX_TRAIN_HEADER),
                       ("multimodal_eval_results.csv", JAX_EVAL_HEADER)):
        rows = _read_csv(os.path.join(root, "csvs", name))
        assert rows[0] == head and len(rows) == 3
        assert np.isfinite([float(v) for r in rows[1:] for v in r[2:8]]).all()
    post = ckpt.load_posterior(os.path.join(
        root, "models", "bayesian_model_typemultimodal_bathy_patch10_"
        "sss_patch10"))
    assert post.mu.shape == post.rho.shape and post.det
    saved = torch.load(state_path, weights_only=True)
    assert saved["epoch"] == 2 and saved["state"]["step"] == 4
    assert saved["meta"]["scheduler_counts"] == {"multimodal": 4}
    # a finished run resumes to nothing more: the same state comes back
    assert _train(root, state_path, packed=packed)
    again = torch.load(state_path, weights_only=True)
    assert torch.equal(again["state"]["post"]["mu"],
                       saved["state"]["post"]["mu"])


def test_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """A run stopped at the first batch of epoch 1 and resumed from its
    checkpoint ends bit-equal to an uninterrupted run: the posterior, the
    Adam state and the running statistics (per-epoch generators from the
    base seed and the epoch index, shuffles pinned to the epoch)."""
    monkeypatch.chdir(tmp_path)
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    assert _train(root, a)
    guard = _StopAtCheck(3)  # epoch 0 polls twice; epoch 1's first poll
    assert _train(root, b, preemption_guard=guard)
    assert guard.triggered
    assert torch.load(b, weights_only=True)["epoch"] == 1
    assert _train(root, b)  # a fresh call resumes at epoch 1
    sa = torch.load(a, weights_only=True)
    sb = torch.load(b, weights_only=True)
    assert sb["epoch"] == sa["epoch"] == 2

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from flat(tree[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, path + (i,))
        else:
            yield path, tree

    fa, fb = dict(flat(sa["state"])), dict(flat(sb["state"]))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_training_refusals(tmp_path):
    """Flags of paths not ported yet raise, naming their ROADMAP item,
    before anything runs; so does an unknown remat."""
    for kw, item in (({"async_checkpoints": True}, "async"),
                     ({"mesh_spec": object()}, "parallel"),
                     ({"dist_spec": object()}, "parallel"),
                     ({"remat": "auto"}, "remat"),
                     ({"mc_chunk": 5}, "training")):
        with pytest.raises(NotImplementedError, match=item):
            _train(str(tmp_path), None, **kw)
