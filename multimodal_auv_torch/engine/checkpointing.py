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
writes. Under fsdp (``engine/optim.py::ShardedAdam``) ``save_train_state``
gathers mu, rho and their moments first (``full_posterior`` and the
optimizer's ``state_dict``, collectives every rank joins, on the caller's
thread), so the file is the one a single process writes; the loops pass
``save_model`` the gathered posterior the same way. Every rank reads the
file to resume, and ``restore_train_state`` copies only this rank's shard
of mu and rho into a sharded state. Tensors are saved on
the CPU and restored onto the device of the state they are restored into.

``async_save=True`` (the JAX package's orbax ``AsyncCheckpointer``
contract): the device-to-host copy is made before the call returns, as a
snapshot of CPU tensors, so a state changed afterwards does not reach the
file; only ``torch.save`` and the atomic rename run in the background, on
one worker thread that writes back-to-back saves in order. The path check
(a collective under a process group) runs on the calling thread. A
synchronous save first drains the queue, so an older background write
never lands over a newer file (the loops' crash-saves), and every read
here drains it too. ``wait_for_saves()`` blocks until the queue is empty
and raises the first error of a background write.

``load_and_fix_state_dict`` is the tolerant restore of a ``save_model``
file: leaves whose name is unknown or whose shape differs keep the
caller's values, with a warning that names them.

Not ported on purpose: the JAX package's ``save_pytree`` /
``restore_pytree``, orbax directories of a pytree. The port's files are
``torch.save`` files of its own trees, written by the functions above.
"""
from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from multimodal_auv_torch.bayes.packing import (
    PackedPosterior,
    _clone_structure,
    _set_path,
    tree_to,
)
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    ShardedAdam,
    full_posterior,
)
from multimodal_auv_torch.parallel.distributed import (
    assert_same_across_processes,
    is_coordinator,
)

logger = logging.getLogger(__name__)

# the background writer: one thread, so back-to-back saves commit in order
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []
_LOCK = threading.Lock()


def _post_dict(post: PackedPosterior) -> Dict[str, Any]:
    return {"mu": post.mu, "rho": post.rho, "det": post.det}


def _on_cpu(obj, copy: bool):
    """``obj`` with every tensor detached on the CPU (the optimizer's
    state dict holds device tensors); ``copy``: tensors of their own even
    where they already are CPU tensors (``.cpu()`` of one is no copy), so
    later in-place updates of the state do not reach a background write."""
    if isinstance(obj, dict):
        return {k: _on_cpu(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v, copy) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=copy)
    return obj


def _write(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def wait_for_saves() -> None:
    """Block until every background save has committed; raise the first
    error a background write met (the others are logged). A no-op when
    nothing is in flight."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    first = None
    for fut in pending:
        try:
            fut.result()
        except Exception as e:
            if first is None:
                first = e
            else:
                logger.error("Background checkpoint write failed: %s", e)
    if first is not None:
        raise first


def _atomic_save(obj, path: str, async_save: bool = False) -> str:
    global _WRITER
    path = os.path.abspath(path)
    assert_same_across_processes("checkpoint path", path)
    if not is_coordinator():
        return path
    obj = _on_cpu(obj, copy=async_save)
    if not async_save:
        wait_for_saves()
        _write(obj, path)
        return path
    with _LOCK:
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="auv-ckpt")
        _PENDING.append(_WRITER.submit(_write, obj, path))
    return path


def model_checkpoint_path(csv_path: str, model_type: str) -> str:
    """{dirname(dirname(csv_path))}/models/bayesian_model_type{model_type}."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(csv_path)))
    return os.path.join(base, "models", f"bayesian_model_type{model_type}")


def save_model(post: PackedPosterior, csv_path: str, model_type: str,
               async_save: bool = False) -> Optional[str]:
    """Posterior-only checkpoint on the reference's path scheme. A failed
    write is logged and returns None, as in the reference; with
    ``async_save`` a failure of the background write is raised by
    ``wait_for_saves``."""
    try:
        path = _atomic_save(_post_dict(post),
                            model_checkpoint_path(csv_path, model_type),
                            async_save)
        logger.info("Model checkpoint saved to %s", path)
        return path
    except Exception as e:
        logger.error("Failed to save model checkpoint: %s", e, exc_info=True)
        return None


def load_posterior(path: str, device=None) -> PackedPosterior:
    """The posterior a ``save_model`` file holds, on ``device``."""
    wait_for_saves()
    d = torch.load(path, map_location="cpu", weights_only=True)
    post = PackedPosterior(d["mu"], d["rho"], d["det"])
    return post if device is None else post.to(device)


def save_train_state(path: str, state: BayesTrainState, epoch: int,
                     scheduler_counts: Optional[Dict[str, int]] = None,
                     async_save: bool = False) -> str:
    """Write (posterior, Adam state, BatchNorm statistics, step, epoch,
    scheduler counts) to ``path``: the whole posterior and moments, also
    under fsdp, whose gathers every rank joins."""
    return _atomic_save({
        "state": {"post": _post_dict(full_posterior(state)),
                  "opt_state": state.opt_state.state_dict(),
                  "batch_stats": state.batch_stats,
                  "step": int(state.step)},
        "epoch": int(epoch),
        "meta": {"scheduler_counts": dict(scheduler_counts or {})},
    }, path, async_save)


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
    optimizer keeps its references to them); a template sharded by fsdp
    takes this rank's shard of mu, rho and their moments.

    ``scheduler_counts`` is ``None`` when the file holds no scheduler
    metadata; resume callers must refuse to proceed then (without it the
    wrong-model guard cannot run and the LR schedule would restart)."""
    wait_for_saves()
    d = torch.load(os.path.abspath(path), map_location="cpu",
                   weights_only=True)
    saved = d["state"]
    post = state_template.post
    src = saved["post"]
    if isinstance(state_template.opt_state, ShardedAdam):
        own = state_template.opt_state.own
        src = dict(src, mu=own(src["mu"]), rho=own(src["rho"]))
    with torch.no_grad():
        _copy_tree_({"mu": post.mu, "rho": post.rho, "det": post.det}, src)
    state_template.opt_state.load_state_dict(saved["opt_state"])
    counts = d.get("meta", {}).get("scheduler_counts")
    sched = None if counts is None else {k: int(v) for k, v in counts.items()}
    state = BayesTrainState(post=post, opt_state=state_template.opt_state,
                            batch_stats=tree_to(saved["batch_stats"],
                                                post.mu.device),
                            step=int(saved["step"]))
    return state, int(d["epoch"]), sched


def _leaves(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) of a nested dict, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def load_and_fix_state_dict(post: PackedPosterior, path: str
                            ) -> Tuple[PackedPosterior, bool]:
    """Tolerant restore of a ``save_model`` file into a posterior like
    ``post``: returns ``(new_post, ok)``. A leaf of ``post`` (``mu``,
    ``rho``, ``det/...``) that the file lacks, or holds at another shape,
    keeps the caller's value, and the warning names the first 8 such
    leaves and their count. A file that cannot be read (an orbax directory
    of the JAX package is one) or that matches no leaf returns
    ``(post, False)``. Kept leaves take the caller's dtype and device."""
    try:
        wait_for_saves()
        if os.path.isdir(path):
            raise IsADirectoryError(
                f"{path} is a directory (an orbax checkpoint of the JAX "
                "package); the port reads torch files only")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(raw, dict):
            raise ValueError(f"{path} holds a {type(raw).__name__}, not a "
                             "posterior dict")
    except Exception as e:
        logger.error("Checkpoint restore failed from %s: %s", path, e)
        return post, False
    raw_by_path = dict(_leaves(raw))
    tree = {"mu": post.mu, "rho": post.rho, "det": post.det}
    out = _clone_structure(tree)
    n, dropped = 0, []
    for key, leaf in _leaves(tree):
        n += 1
        cand = raw_by_path.get(key)
        if (isinstance(cand, torch.Tensor)
                and tuple(cand.shape) == tuple(leaf.shape)):
            new = cand.to(device=leaf.device, dtype=leaf.dtype)
            _set_path(out, key, new.requires_grad_(leaf.requires_grad))
            continue
        if isinstance(cand, torch.Tensor):
            logger.warning("Dropping %s: shape %s != %s", key,
                           tuple(cand.shape), tuple(leaf.shape))
        dropped.append(key)
    logger.info("Checkpoint loaded from %s (%d leaves kept, %d dropped)",
                path, n - len(dropped), len(dropped))
    if dropped:
        shown = ["/".join(k) for k in dropped[:8]]
        logger.warning(
            "Checkpoint %s: %d leaves had no match and keep their input "
            "values: %s%s", path, len(dropped), ", ".join(shown),
            "" if len(dropped) <= 8 else f", ... (+{len(dropped) - 8} more)")
    if n and len(dropped) == n:
        logger.error("Checkpoint at %s matched zero leaves", path)
        return post, False
    return PackedPosterior(out["mu"], out["rho"], out["det"]), True
