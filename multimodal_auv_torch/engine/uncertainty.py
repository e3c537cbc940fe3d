"""Monte-Carlo uncertainty estimators (port of
``multimodal_auv_tpu/engine/uncertainty.py``).

* variance estimator (inference): per-class variance of the MC softmax
  stack, unbiased (correction=1), averaged over classes;
* aleatoric: mean per-draw predictive entropy, eps 1e-7 at inference;
* entropy decomposition (multimodal eval): eps 1e-8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    """(num_mc, B, C) logits -> f32 softmax probabilities."""
    return torch.softmax(logits.to(torch.float32), dim=-1)


def mean_probs(probs: torch.Tensor) -> torch.Tensor:
    return probs.mean(dim=0)


def predicted_class(probs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mean_probs(probs), dim=-1)


def variance_uncertainty(probs: torch.Tensor) -> torch.Tensor:
    return probs.var(dim=0, correction=1).mean(dim=-1)


def entropy(p: torch.Tensor, eps: float) -> torch.Tensor:
    return -(p * torch.log(p + eps)).sum(dim=-1)


def aleatoric_uncertainty(probs: torch.Tensor, eps: float = 1e-7
                          ) -> torch.Tensor:
    return entropy(probs, eps).mean(dim=0)


class EntropyDecomposition(NamedTuple):
    predictive: torch.Tensor  # entropy of the mean softmax
    aleatoric: torch.Tensor   # expected entropy
    model: torch.Tensor       # epistemic: predictive - aleatoric


def entropy_decomposition(probs: torch.Tensor, eps: float = 1e-8
                          ) -> EntropyDecomposition:
    predictive = entropy(mean_probs(probs), eps)
    aleatoric = entropy(probs, eps).mean(dim=0)
    return EntropyDecomposition(predictive, aleatoric, predictive - aleatoric)
