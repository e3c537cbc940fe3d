"""The mesh of ranks (port of ``multimodal_auv_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a (data, mc) mesh and lets the SPMD
partitioner insert the collectives. Here one process drives one card, so a
data x mc mesh is data x mc ranks, rank = d * mc + m (JAX's row-major
``devices[:n].reshape(data, mc)``), and the collectives are written out
(``parallel/collectives.py``):

* ``data``: each batch's rows are split over the data ranks; train-mode
  BatchNorm reduces its statistics over the data axis (the ranks that share
  m), so they are the global batch's; the gradients are summed over all
  ranks;
* ``mc``: each chunk's Monte-Carlo draws are split over the mc ranks (the
  ranks that share d), each drawing its own rows of the chunk from the
  chunk's seed with its draw offset folded in (``ops/sampling.py::
  draw_offset_seed``); the logits are gathered over the mc axis.

With ``fsdp`` the Adam moments of the packed mu and rho live on 1024-aligned
shards of all ranks (``engine/optim.py::ShardedAdam``): optimizer-state
sharding only, since mu and rho stay whole on every rank for the forward;
the BatchNorm statistics and every other leaf stay replicated. Without a process group
``make_mesh(MeshSpec(1, 1))`` is a mesh of one rank on which every
collective is a no-op, as JAX's one-device mesh is. Unlike JAX, which can
leave devices idle, a mesh must use every rank: data x mc == world size.

Not ported on purpose: the JAX package's ``batch_sharding``,
``replicated``, ``shard_batch``, ``state_shardings`` and ``mc_sharding``,
which build ``jax.sharding`` objects for the partitioner. The port passes
the ``Mesh`` itself to the steps, loops and pipelines.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist

from multimodal_auv_torch.config import MeshSpec
from multimodal_auv_torch.parallel import distributed as D
from multimodal_auv_torch.parallel.collectives import LOCAL, Axis, local_shards

logger = logging.getLogger(__name__)

SHARD_ALIGN = 1024  # the JAX package's pad multiple


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a data x mc mesh: the two axes it sits on (the
    data axis: the ranks sharing its m; the mc axis: the ranks sharing its
    d), the world axis of the gradient sums, and ``fsdp``."""

    data: int
    mc: int
    rank: int
    data_axis: Axis
    mc_axis: Axis
    world_axis: Axis
    fsdp: bool = False

    @property
    def shape(self):
        return {"data": self.data, "mc": self.mc}

    @property
    def coords(self) -> Tuple[int, int]:
        return self.data_axis.index, self.mc_axis.index


def local_shards_mesh(n: int) -> Mesh:
    """The mesh of ``n`` data shards run by threads of this process
    (serving.py's data-sharded DVP program): its data axis
    ``local_shards(n)``, whose index is the worker thread's at run time;
    the other axes of size 1."""
    return Mesh(data=int(n), mc=1, rank=0, data_axis=local_shards(n),
                mc_axis=LOCAL, world_axis=LOCAL)


def mesh_shape(spec: Optional[MeshSpec]) -> Tuple[int, int]:
    """(data, mc) of ``spec`` over the process group, or ValueError when
    it does not use exactly every process. ``spec`` None: every rank on
    the data axis; ``data`` 0: the world size // mc."""
    world = D.process_count()
    if spec is None:
        return world, 1
    mc = max(spec.mc, 1)
    data = spec.data if spec.data and spec.data > 0 else max(world // mc, 1)
    if data * mc != world:
        raise ValueError(
            f"mesh {data}x{mc} needs {data * mc} processes (one per card), "
            f"the process group has {world}")
    return data, mc


def make_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """The mesh of ``spec`` over the process group (one rank when there is
    none; see ``mesh_shape``). Every rank must call this, in the same
    order, since it creates the axes' process groups."""
    world, rank = D.process_count(), D.process_index()
    data, mc = mesh_shape(spec)
    d, m = divmod(rank, mc)

    def axis(members_of, n_groups, size, index, mine):
        if size == 1:
            return Axis(1, 0, None)
        if size == world:
            return Axis(size, index, None)
        group = None
        for g in range(n_groups):  # every rank creates every group
            pg = dist.new_group(members_of(g))
            if g == mine:
                group = pg
        return Axis(size, index, group)

    data_axis = axis(lambda j: [i * mc + j for i in range(data)], mc, data,
                     d, m)
    mc_axis = axis(lambda j: [j * mc + i for i in range(mc)], data, mc, m, d)
    return Mesh(data, mc, rank, data_axis, mc_axis,
                Axis(world, rank, None), bool(spec is not None and spec.fsdp))


def posterior_sharding(mesh: Mesh, n: int, fsdp: bool
                       ) -> Optional[Tuple[int, int]]:
    """This rank's [lo, hi) of a flat length-``n`` vector under ``fsdp``
    (``SHARD_ALIGN``-aligned, the last shard ragged, trailing ones possibly
    empty), or None when the vector is replicated."""
    if not fsdp:
        return None
    world = mesh.world_axis.size
    per = -(-n // (SHARD_ALIGN * world)) * SHARD_ALIGN
    return min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)


def shard_optimizer(mesh: Mesh, tx, post, fsdp: bool = False):
    """``tx.init(post)``, or under ``fsdp`` the optimizer whose Adam
    moments live on this rank's shard of mu and rho (``ShardedAdam``)."""
    bounds = posterior_sharding(mesh, post.mu.shape[0], fsdp)
    if bounds is None:
        return tx.init(post)
    from multimodal_auv_torch.engine.optim import ShardedAdam

    return ShardedAdam(tx, post, bounds, mesh.world_axis)


def shard_state(mesh: Mesh, state, tx, fsdp: bool = False):
    """A ``BayesTrainState`` whose optimizer is ``shard_optimizer``'s."""
    from multimodal_auv_torch.engine.optim import BayesTrainState

    return BayesTrainState(post=state.post,
                           opt_state=shard_optimizer(mesh, tx, state.post,
                                                     fsdp),
                           batch_stats=state.batch_stats, step=state.step)


def training_mesh(mesh_spec, batch_size: int, num_mc: int, mc_chunk: int):
    """(mesh, mc_chunk) of a training run: the batch must split evenly over
    the data axis, and under an mc axis every chunk must span it (the
    chunk is raised to the axis when it does not divide)."""
    mesh = make_mesh(mesh_spec)
    if batch_size % mesh.data:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the mesh "
            f"'data' axis ({mesh.data}): every (padded) batch is split "
            f"evenly across data ranks")
    if mesh.mc > 1:
        if mc_chunk % mesh.mc:
            logger.info("mesh mc=%d: raising mc_chunk %d -> %d so each "
                        "sampled chunk spans the ensemble axis", mesh.mc,
                        mc_chunk, mesh.mc)
            mc_chunk = mesh.mc
        if num_mc % mc_chunk:
            raise ValueError(
                f"num_mc ({num_mc}) must be divisible by the mc chunk "
                f"({mc_chunk}) under an mc={mesh.mc} mesh")
    return mesh, mc_chunk


def shard_loaders(mesh, train_loader, test_loader, packed: bool):
    """Each data rank decodes only its rows of every global batch."""
    if mesh.world_axis.size == 1:
        return train_loader, test_loader
    d, n = mesh.data_axis.index, mesh.data
    if packed:
        from multimodal_auv_torch.data.packing import HostShardPackedBatches

        return (HostShardPackedBatches.from_batches(train_loader, d, n),
                HostShardPackedBatches.from_batches(test_loader, d, n))
    from multimodal_auv_torch.data.loaders import HostShardLoader

    return (HostShardLoader.from_loader(train_loader, d, n),
            HostShardLoader.from_loader(test_loader, d, n))


def wrap_train_step(mesh: Mesh, step):
    """The loops' train step over the mesh (global-shaped batches in,
    global metrics out); on a one-rank mesh the step itself."""
    if mesh.world_axis.size == 1:
        return step
    return D.wrap_train_step_multihost(mesh, step)


def wrap_eval_step(mesh: Mesh, step):
    """The eval twin of ``wrap_train_step``."""
    if mesh.world_axis.size == 1:
        return step
    return D.wrap_eval_step_multihost(mesh, step)
