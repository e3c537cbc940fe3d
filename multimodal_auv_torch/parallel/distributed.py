"""Multi-process execution (port of ``multimodal_auv_tpu/parallel/
distributed.py``).

JAX runs one process per host over a device mesh. PyTorch runs one process
per card: every process calls ``initialize_distributed`` (a
``torch.distributed`` process group with a ``tcp://`` rendezvous at the
coordinator), builds the same mesh (``parallel/mesh.py``) and runs the same
pipeline on its own rows and draws. Host-side data loading becomes a
per-data-rank slice of every global batch (``data/loaders.py::
HostShardLoader``, ``data/packing.py::HostShardPackedBatches``), the
analogue of torch's DistributedSampler.

The step wrappers keep the epoch loops' single-process view: the loops
hand over global-shaped batches, the wrapper takes this rank's rows, runs
the step and gathers its per-sample outputs back to the global batch.
"""
from __future__ import annotations

import logging
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from multimodal_auv_torch.device import local_device_index
from multimodal_auv_torch.parallel.collectives import (
    COUNTS,
    Axis,
    all_reduce_,
    gather_rows,
)

logger = logging.getLogger(__name__)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           initialization_timeout: int = 300,
                           backend: Optional[str] = None) -> int:
    """Join the process group (a no-op for one process, or when a group is
    up already); returns this process's rank. ``backend`` None: NCCL where
    a card is present, gloo on the CPU. Under NCCL the process's card is
    made current before anything is allocated on it."""
    if dist.is_initialized() or not num_processes or num_processes <= 1:
        return process_index()
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "'host:port' and this process's process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device_index(process_id))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=initialization_timeout))
    logger.info("Distributed initialized: process %d/%d (%s)",
                dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_rank()


def maybe_initialize_distributed(dist_spec=None) -> int:
    """The pipelines' hook: join the process group of an explicit
    ``DistSpec``, else of the AUV_* environment (``DistSpec.from_env``),
    else nothing. Runs before any model or mesh is built; returns the
    rank."""
    from multimodal_auv_torch.config import DistSpec

    spec = dist_spec if dist_spec is not None else DistSpec.from_env()
    if spec is not None and spec.num_processes > 1:
        return initialize_distributed(
            spec.coordinator, spec.num_processes, spec.process_id,
            initialization_timeout=spec.initialization_timeout,
            backend=spec.backend)
    return process_index()


def _world() -> Axis:
    return Axis(process_count(), process_index(), None)


def _flag_device() -> torch.device:
    """Where a small control tensor lives: the card under NCCL, else the
    CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every process waits here for every other: one all_reduce of a zero
    (no-op for one process)."""
    all_reduce_(torch.zeros(1, device=_flag_device()), _world())


def assert_same_across_processes(tag: str, value: str) -> None:
    """Raise on EVERY process when ``value`` differs between processes
    (e.g. a checkpoint path written by rank 0 and read by all): rank 0's
    value is broadcast, each rank compares it with its own, and one
    all_reduce of the mismatch flags makes the verdict the same
    everywhere. Needs every process to reach the same calls in the same
    order; a no-op for one process."""
    if process_count() <= 1:
        return
    obj = [value]
    dist.broadcast_object_list(obj, src=0)
    COUNTS["broadcast"] += 1
    bad = torch.tensor([float(obj[0] != value)], device=_flag_device())
    all_reduce_(bad, _world())
    if bad.item() > 0:
        raise ValueError(
            f"{tag!r} must be identical on every process, rank 0 has "
            f"{obj[0]!r} and this rank {value!r}: point every process at "
            f"the same shared path")


def host_shard_indices(n_samples: int, *,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> List[int]:
    """This process's contiguous shard of range(n_samples) (the trailing
    process gets the ragged tail)."""
    grouped = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if grouped else 0
    if process_count is None:
        process_count = dist.get_world_size() if grouped else 1
    per = -(-n_samples // process_count)
    return list(range(process_index * per,
                      min((process_index + 1) * per, n_samples)))


def is_coordinator() -> bool:
    """True on the process that owns the run's ledgers (CSV rows, TB
    events, manifests, confusion PNGs, checkpoint files)."""
    return process_index() == 0


def host_rows(mesh, a):
    """This rank's contiguous rows of a global-shaped batch array: data
    rank d of D takes rows [d * B / D, (d + 1) * B / D)."""
    per = a.shape[0] // mesh.data
    d = mesh.data_axis.index
    return a[d * per:(d + 1) * per]


def wrap_train_step_multihost(mesh, step):
    """The epoch loops' train step over the mesh: (state, inputs, labels,
    mask, generator, kl_weight, n) with global-shaped batches; this
    rank's rows go to ``step`` (built with ``mesh=``), and the metrics
    come back with ``predicted`` gathered to the global batch."""

    def wrapped(state, inputs, labels, mask, generator, kl_weight, n):
        rows = lambda a: host_rows(mesh, a)
        state, m = step(state, [rows(a) for a in inputs], rows(labels),
                        rows(mask), generator, kl_weight, n)
        # 6 global scalars, then the per-row predictions
        predicted = gather_rows(m["fused"][6:], mesh.data_axis)
        return state, dict(m, fused=torch.cat([m["fused"][:6], predicted]),
                           predicted=predicted.to(m["predicted"].dtype))

    return wrapped


def wrap_eval_step_multihost(mesh, step):
    """The eval twin: the metrics' per-sample vectors and mean_prob
    gathered to the global batch."""

    def wrapped(post, batch_stats, inputs, labels, mask, generator,
                kl_scale):
        rows = lambda a: host_rows(mesh, a)
        m = step(post, batch_stats, [rows(a) for a in inputs], rows(labels),
                 rows(mask), generator, kl_scale)
        b, c = m["mean_prob"].shape
        vec = m["fused"]
        # 5 scalars, then 6 per-sample vectors, then (b, C) mean_prob
        vecs = vec[5:5 + 6 * b].reshape(6, b)
        probs = vec[5 + 6 * b:].reshape(b, c)
        per_row = torch.cat([vecs.T, probs], dim=1)  # (b, 6 + C)
        per_row = gather_rows(per_row.contiguous(), mesh.data_axis)
        fused = torch.cat([vec[:5], per_row[:, :6].T.reshape(-1),
                           per_row[:, 6:].reshape(-1)])
        return dict(m, fused=fused,
                    predicted=per_row[:, 0].to(m["predicted"].dtype),
                    mean_prob=per_row[:, 6:])

    return wrapped
