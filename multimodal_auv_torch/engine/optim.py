"""Optimizer, LR schedule and training state (port of
``multimodal_auv_tpu/engine/optim.py``).

The reference trains with torch.optim.Adam(lr, weight_decay) + StepLR
(train/loop_utils.py:13-63). Its weight decay is an L2 term added to the
gradient before the Adam moments (coupled, not AdamW), which is what the
JAX package's ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` chain
computes, and what ``torch.optim.Adam(weight_decay=wd)`` computes here.
The chain covers the whole packed posterior, so the optimizer holds mu,
rho and every BatchNorm scale and bias of ``post.det``, and the decay
applies to all of them.

The port updates the posterior in place: the optimizer owns references
to the posterior's leaf tensors, and a train step changes them where they
are (the JAX state is immutable and replaced every step).

Frozen-backbone fine-tuning (``make_optimizer_with_freeze``) puts an
elementwise gate between the decay and Adam, in the JAX chain's order
(``add_decayed_weights -> freeze_transform -> scale_by_adam -> scale``):
frozen elements neither decay nor build up moments, so they stay bit for
bit unchanged.

``define_optimizers_and_schedulers`` builds an Adam and a ``StepLR`` per
model from the reference's param dicts (``lr``, ``weight_decay``,
``step_size``, ``gamma``). Not ported on purpose: the JAX package's
``freeze_transform``, an optax gradient transform; the port's gate is
``GatedAdam``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, PackMeta
from multimodal_auv_torch.config import OptimizerSpec, SchedulerSpec

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def trainable_leaves(post: PackedPosterior) -> List[torch.Tensor]:
    """mu, rho, then the BatchNorm affine leaves of ``post.det`` in sorted
    path order: what the optimizer updates."""
    return [post.mu, post.rho] + _leaves(post.det)


@dataclass(frozen=True)
class AdamDef:
    """torch.optim.Adam semantics (betas 0.9/0.999, eps 1e-8, coupled L2);
    ``init`` builds the optimizer over a posterior, marking its leaves
    trainable."""

    lr: float
    weight_decay: float

    def init(self, post: PackedPosterior) -> torch.optim.Adam:
        params = [p.requires_grad_(True) for p in trainable_leaves(post)]
        return torch.optim.Adam(params, lr=self.lr, betas=BETAS, eps=ADAM_EPS,
                                weight_decay=self.weight_decay)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.0) -> AdamDef:
    return AdamDef(float(lr), float(weight_decay))


def make_backbone_freeze_mask(meta: PackMeta, post: PackedPosterior,
                              trainable_prefixes: Sequence[str] = (
                                  "attention_", "fc")) -> PackedPosterior:
    """Elementwise update mask for fine-tuning with a frozen backbone
    (BASELINE configs[3]), on the posterior's device: 1.0 on the packed
    regions whose top-level module starts with a trainable prefix (the
    fusion head: attention_*, fc / fc1 / fc2), 0.0 on the ResNet trunks,
    the pad and every deterministic (BatchNorm) leaf."""
    mask = np.zeros(meta.n_padded, np.float32)
    for e in meta.entries:
        if any(e.path[0].startswith(p) for p in trainable_prefixes):
            mask[e.offset:e.offset + e.size] = 1.0
    flat = torch.from_numpy(mask).to(post.mu.device)
    return PackedPosterior(mu=flat, rho=flat, det=_zeros_like(post.det))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, requires_grad=False)


class GatedAdam(torch.optim.Adam):
    """Adam behind an elementwise gate: each step replaces every gradient
    g by (g + weight_decay * p) * mask, then runs Adam without decay. An
    element whose mask is 0 gets a zero gradient: its moments stay exactly
    zero and its update is zero."""

    def __init__(self, params: List[torch.Tensor], masks: List[torch.Tensor],
                 lr: float, weight_decay: float):
        super().__init__(params, lr=lr, betas=BETAS, eps=ADAM_EPS,
                         weight_decay=0.0)
        self.masks = masks
        self.decay = weight_decay

    @torch.no_grad()
    def step(self, closure=None):
        for p, m in zip(self.param_groups[0]["params"], self.masks):
            if p.grad is not None:
                if self.decay:
                    p.grad.add_(p, alpha=self.decay)
                p.grad.mul_(m)
        return super().step(closure)


@dataclass(frozen=True)
class GatedAdamDef:
    """``AdamDef`` with the frozen-backbone gate (``GatedAdam``); ``mask``
    is a ``make_backbone_freeze_mask`` tree of the posterior it inits."""

    lr: float
    weight_decay: float
    mask: PackedPosterior

    def init(self, post: PackedPosterior) -> GatedAdam:
        params = [p.requires_grad_(True) for p in trainable_leaves(post)]
        return GatedAdam(params, trainable_leaves(self.mask), self.lr,
                         self.weight_decay)


def make_optimizer_with_freeze(lr: float, weight_decay: float,
                               mask_post: PackedPosterior) -> GatedAdamDef:
    """Adam with the frozen-backbone gate in front; the un-frozen path is
    ``make_optimizer``."""
    return GatedAdamDef(float(lr), float(weight_decay), mask_post)


class StepLR:
    """Host-side replica of torch.optim.lr_scheduler.StepLR."""

    def __init__(self, base_lr: float, step_size: int, gamma: float):
        self.base_lr = base_lr
        self.step_size = step_size
        self.gamma = gamma
        self.epoch_count = 0

    @property
    def lr(self) -> float:
        return self.base_lr * self.gamma ** (self.epoch_count // self.step_size)

    def step(self):
        self.epoch_count += 1

    def state_dict(self):
        return {"epoch_count": self.epoch_count}

    def load_state_dict(self, d):
        self.epoch_count = d["epoch_count"]


@dataclass
class OptimizerBundle:
    """One model's optimizer definition (``tx.init(post)`` builds the Adam)
    and its learning-rate schedule."""

    tx: AdamDef
    scheduler: StepLR


def define_optimizers_and_schedulers(
    model_names,
    optimizer_params: Dict[str, Dict[str, float]],
    scheduler_params: Dict[str, Dict[str, float]],
) -> Dict[str, OptimizerBundle]:
    """An Adam + StepLR pair per model name from the reference's param
    dicts, keyed by model name: ``lr`` and ``weight_decay`` (default
    ``OptimizerSpec``'s), ``step_size`` and ``gamma`` (default
    ``SchedulerSpec``'s)."""
    out = {}
    for name in model_names:
        op = optimizer_params.get(name, {})
        sp = scheduler_params.get(name, {})
        lr = float(op.get("lr", OptimizerSpec.lr))
        wd = float(op.get("weight_decay", OptimizerSpec.weight_decay))
        out[name] = OptimizerBundle(
            tx=make_optimizer(lr, wd),
            scheduler=StepLR(lr, int(sp.get("step_size",
                                            SchedulerSpec.step_size)),
                             float(sp.get("gamma", SchedulerSpec.gamma))))
    return out


@dataclass
class BayesTrainState:
    """Training state of one Bayesian model: the posterior (updated in
    place by ``opt_state``, the Adam optimizer over its leaves), the
    BatchNorm running statistics and the count of train steps taken."""

    post: PackedPosterior
    opt_state: torch.optim.Adam
    batch_stats: Dict[str, Any]
    step: int = 0


def _detached_copy(tree):
    if isinstance(tree, dict):
        return {k: _detached_copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def fresh_train_state(post: PackedPosterior, batch_stats, tx) -> BayesTrainState:
    """A train state at step 0 over copies of ``post`` and ``batch_stats``,
    with a new optimizer of ``tx``. The train step updates its posterior
    in place, so a study that restarts from the same weights (each noise
    level, each sweep combo: the JAX package reuses its immutable arrays)
    trains copies and leaves ``post`` as it was."""
    copy = PackedPosterior(post.mu.detach().clone(), post.rho.detach().clone(),
                           _detached_copy(post.det))
    return BayesTrainState(post=copy, opt_state=tx.init(copy),
                           batch_stats=_detached_copy(batch_stats))


def set_learning_rate(opt_state: torch.optim.Optimizer, lr: float):
    """Set the learning rate of every parameter group."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


def kl_annealing_weight(epoch: int, total_num_epochs: int) -> float:
    """kl_weight = 2^(epoch+1) / 2^total_epochs
    (the reference's train/multimodal.py:80)."""
    return float(2.0 ** (epoch + 1 - total_num_epochs))


class ShardedAdam:
    """The optimizer of ``tx`` (``AdamDef`` or ``GatedAdamDef``) over this
    rank's [lo, hi) shard of the packed mu and rho: the ``fsdp`` of
    ``parallel/mesh.py``, which keeps mu, rho and their Adam moments
    sharded at rest over every rank, as the JAX package's
    ``posterior_sharding`` does. The shard is the master copy: the state's
    posterior (``shard_state``) holds only it, with the deterministic
    leaves (replicated, like their moments), and Adam steps on it alone.

    The train step gathers mu and rho for its forward (``gather``, one
    ``all_gather_flat`` each), reduce-scatters their gradients onto the
    shard (``scatter_grads``) and frees the full vectors before it
    returns; every other caller that needs the whole posterior (the
    evaluations, the checkpoints, the pipelines' result) takes it from
    ``full_posterior``, which every rank must join. Over N ranks a rank
    keeps 2 P / N of posterior, 2 P / N of gradients and 4 P / N of
    moments, against 8 P unsharded. ``state_dict`` gathers the moments to
    the unsharded optimizer's format, so a checkpoint is the same file
    with or without fsdp; ``load_state_dict`` takes this rank's shard of
    one."""

    def __init__(self, tx, shard: PackedPosterior, bounds, n: int, axis):
        (self.lo, self.hi), self.n, self.axis = bounds, int(n), axis
        lo, hi = self.lo, self.hi
        if isinstance(tx, GatedAdamDef):
            m = tx.mask
            tx = GatedAdamDef(tx.lr, tx.weight_decay, PackedPosterior(
                mu=m.mu[lo:hi], rho=m.rho[lo:hi], det=m.det))
        self.inner = tx.init(shard)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def own(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole length-n vector."""
        return full[self.lo:self.hi]

    def gather(self, shard: PackedPosterior,
               requires_grad: bool = False) -> PackedPosterior:
        """The whole posterior of the shard ``shard``: mu and rho gathered
        over the axis (new tensors, leaves of their own that require grad
        when asked), the deterministic leaves as they are. Every rank of
        the axis must call it."""
        from multimodal_auv_torch.parallel.collectives import all_gather_flat

        def full(t):
            out = all_gather_flat(t.detach(), self.axis, self.n).detach()
            return out.requires_grad_(True) if requires_grad else out

        return PackedPosterior(full(shard.mu), full(shard.rho), shard.det)

    def scatter_grads(self, full: PackedPosterior,
                      shard: PackedPosterior) -> None:
        """Sum the gradients of the gathered mu and rho over the axis onto
        the shard's ``.grad`` (one ``reduce_scatter_flat`` each) and drop
        them from ``full``."""
        from multimodal_auv_torch.parallel.collectives import (
            reduce_scatter_flat,
        )

        for f, s in ((full.mu, shard.mu), (full.rho, shard.rho)):
            s.grad = (None if f.grad is None else reduce_scatter_flat(
                f.grad, self.axis, (self.lo, self.hi)))
            f.grad = None

    @torch.no_grad()
    def step(self):
        self.inner.step()

    def state_dict(self):
        from multimodal_auv_torch.parallel.collectives import all_gather_flat

        sd = self.inner.state_dict()
        state = dict(sd["state"])
        for i in (0, 1):  # mu and rho
            if i in state:
                state[i] = {k: (all_gather_flat(v, self.axis, self.n)
                                if k.startswith("exp_avg") else v)
                            for k, v in state[i].items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd) -> None:
        state = dict(sd["state"])
        for i in (0, 1):
            if i in state:
                state[i] = {k: (self.own(v).clone()
                                if k.startswith("exp_avg") else v)
                            for k, v in state[i].items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})


def full_posterior(state: BayesTrainState,
                   requires_grad: bool = False) -> PackedPosterior:
    """The whole posterior of a train state: ``state.post`` itself, or
    under fsdp (a ``ShardedAdam``) mu and rho gathered from every rank's
    shard, which every rank must join (``requires_grad``: the gathered
    vectors are leaves that require grad, as the train step differentiates
    them). The one way the train step, the loops, the checkpoints and the
    pipelines read a train state's posterior."""
    opt = state.opt_state
    if isinstance(opt, ShardedAdam):
        return opt.gather(state.post, requires_grad=requires_grad)
    return state.post
