"""Faults planted in the program underneath a run, to show that the
comparison catches them (the benchmark's tests on the CPU; ``calibrate.py
--fault`` on the card). Each patches one function of the program where
the fault would arise and returns nothing; ``undo()`` of the returned
list puts the originals back.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def half_batch() -> List[Tuple[object, str, object]]:
    """Half of the batch left out, the means taken over the rest:
    BatchNorm's statistics and the training loss over the first half of
    the rows only."""
    from multimodal_auv_torch.engine import steps
    from multimodal_auv_torch.models import resnet

    moments, ce_sum = resnet._batch_moments, steps._masked_ce_sum

    def half_moments(x32, mask):
        n = x32.shape[0] // 2
        return moments(x32[:n], None if mask is None else mask[:n])

    def half_ce(output, labels, mask):
        # twice the first half's sum: the step's division by the count
        # of rows gives the first half's mean
        n = output.shape[0] // 2
        return 2.0 * ce_sum(output[:n], labels[:n], mask[:n])

    return [(resnet, "_batch_moments", half_moments),
            (steps, "_masked_ce_sum", half_ce)]


def altered_answer():
    """One patch's predictive uncertainty changed where it is made."""
    from multimodal_auv_torch.engine import uncertainty as U

    variance = U.variance_uncertainty

    def altered(probs):
        v = variance(probs).clone()
        v[0] = v[0] * 1.5
        return v

    return [(U, "variance_uncertainty", altered)]


def class_order():
    """The classes out of order where the probabilities are made: each
    draw's probabilities moved one class along, so the mean probabilities
    and the predicted class are another class's, and the uncertainties,
    which do not depend on the order, are unchanged."""
    from multimodal_auv_torch.engine import uncertainty as U

    softmax = U.softmax_probs

    def rolled(logits):
        return torch.roll(softmax(logits), 1, dims=-1)

    return [(U, "softmax_probs", rolled)]


def unchanged_state():
    """An optimizer step that leaves the parameters as they were."""
    return [(torch.optim.Adam, "step", lambda self, closure=None: None)]


FAULTS: Dict[str, Callable] = {"half_batch": half_batch,
                               "altered_answer": altered_answer,
                               "class_order": class_order,
                               "unchanged_state": unchanged_state}


def plant(name: str) -> List[Tuple[object, str, object]]:
    """Patch the program with fault ``name``; returns what ``undo`` needs."""
    saved = []
    for owner, attr, fn in FAULTS[name]():
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)
    return saved


def undo(saved) -> None:
    for owner, attr, fn in reversed(saved):
        setattr(owner, attr, fn)
