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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior

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
class BayesTrainState:
    """Training state of one Bayesian model: the posterior (updated in
    place by ``opt_state``, the Adam optimizer over its leaves), the
    BatchNorm running statistics and the count of train steps taken."""

    post: PackedPosterior
    opt_state: torch.optim.Adam
    batch_stats: Dict[str, Any]
    step: int = 0


def set_learning_rate(opt_state: torch.optim.Optimizer, lr: float):
    """Set the learning rate of every parameter group."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


def kl_annealing_weight(epoch: int, total_num_epochs: int) -> float:
    """kl_weight = 2^(epoch+1) / 2^total_epochs
    (the reference's train/multimodal.py:80)."""
    return float(2.0 ** (epoch + 1 - total_num_epochs))
