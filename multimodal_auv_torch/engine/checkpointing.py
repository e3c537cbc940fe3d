"""Checkpointing with ``torch.save``, with full resume (port of
``multimodal_auv_tpu/engine/checkpointing.py``, which uses orbax).

* ``save_model(post, csv_path, model_type)`` writes the posterior to
  ``{dirname(dirname(csv_path))}/models/bayesian_model_type{model_type}``,
  the reference's path scheme (its train/checkpointing.py:7-44).
* ``save_train_state`` / ``restore_train_state`` persist (posterior, Adam
  state, BatchNorm statistics, step, epoch, scheduler counts) in one file,
  so the scheduler metadata commits together with the weights.

Every file is written to a temporary name and renamed into place, so a
crash mid-write leaves the previous checkpoint whole. Under a process
group every rank checks that it names the same path
(``parallel.distributed.assert_same_across_processes``) and rank 0 alone
writes: the posterior is replicated, and a sharded optimizer's
``state_dict`` gathers its moments (a collective every rank joins), so the
file is the one a single process writes. Every rank reads the file to
resume. Tensors are saved on
the CPU and restored onto the device of the state they are restored into.
Async saving is not ported yet (``async_save=True`` raises).
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, tree_to
from multimodal_auv_torch.engine.mc import not_ported
from multimodal_auv_torch.engine.optim import BayesTrainState
from multimodal_auv_torch.parallel.distributed import (
    assert_same_across_processes,
    is_coordinator,
)

logger = logging.getLogger(__name__)
_ASYNC = ("async checkpoint saves", "5 (training: async checkpoints)")


def _detached_cpu(tree):
    if isinstance(tree, dict):
        return {k: _detached_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _post_dict(post: PackedPosterior) -> Dict[str, Any]:
    return _detached_cpu({"mu": post.mu, "rho": post.rho, "det": post.det})


def _atomic_save(obj, path: str) -> str:
    path = os.path.abspath(path)
    assert_same_across_processes("checkpoint path", path)
    if not is_coordinator():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def model_checkpoint_path(csv_path: str, model_type: str) -> str:
    """{dirname(dirname(csv_path))}/models/bayesian_model_type{model_type}."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(csv_path)))
    return os.path.join(base, "models", f"bayesian_model_type{model_type}")


def save_model(post: PackedPosterior, csv_path: str, model_type: str,
               async_save: bool = False) -> Optional[str]:
    """Posterior-only checkpoint on the reference's path scheme. A failed
    write is logged and returns None, as in the reference."""
    if async_save:
        raise not_ported(*_ASYNC)
    try:
        path = _atomic_save(_post_dict(post),
                            model_checkpoint_path(csv_path, model_type))
        logger.info("Model checkpoint saved to %s", path)
        return path
    except Exception as e:
        logger.error("Failed to save model checkpoint: %s", e, exc_info=True)
        return None


def load_posterior(path: str, device=None) -> PackedPosterior:
    """The posterior a ``save_model`` file holds, on ``device``."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    post = PackedPosterior(d["mu"], d["rho"], d["det"])
    return post if device is None else post.to(device)


def save_train_state(path: str, state: BayesTrainState, epoch: int,
                     scheduler_counts: Optional[Dict[str, int]] = None,
                     async_save: bool = False) -> str:
    if async_save:
        raise not_ported(*_ASYNC)
    return _atomic_save({
        "state": {"post": _post_dict(state.post),
                  "opt_state": state.opt_state.state_dict(),
                  "batch_stats": _detached_cpu(state.batch_stats),
                  "step": int(state.step)},
        "epoch": int(epoch),
        "meta": {"scheduler_counts": dict(scheduler_counts or {})},
    }, path)


def _copy_tree_(dst, src, where=()) -> None:
    if isinstance(dst, dict):
        if sorted(dst) != sorted(src):
            raise ValueError(f"checkpoint tree at {where} has keys "
                             f"{sorted(src)}, the state {sorted(dst)}")
        for k in dst:
            _copy_tree_(dst[k], src[k], where + (k,))
        return
    if dst.shape != src.shape:
        raise ValueError(f"checkpoint leaf {where} has shape "
                         f"{tuple(src.shape)}, the state {tuple(dst.shape)}")
    dst.copy_(src)


def restore_train_state(path: str, state_template: BayesTrainState):
    """Returns ``(state, epoch, scheduler_counts)``: the template's
    posterior tensors and optimizer take the saved values in place (the
    optimizer keeps its references to them).

    ``scheduler_counts`` is ``None`` when the file holds no scheduler
    metadata; resume callers must refuse to proceed then (without it the
    wrong-model guard cannot run and the LR schedule would restart)."""
    d = torch.load(os.path.abspath(path), map_location="cpu",
                   weights_only=True)
    saved = d["state"]
    post = state_template.post
    with torch.no_grad():
        _copy_tree_({"mu": post.mu, "rho": post.rho, "det": post.det},
                    saved["post"])
    state_template.opt_state.load_state_dict(saved["opt_state"])
    counts = d.get("meta", {}).get("scheduler_counts")
    sched = None if counts is None else {k: int(v) for k, v in counts.items()}
    state = BayesTrainState(post=post, opt_state=state_template.opt_state,
                            batch_stats=tree_to(saved["batch_stats"],
                                                post.mu.device),
                            step=int(saved["step"]))
    return state, int(d["epoch"]), sched
