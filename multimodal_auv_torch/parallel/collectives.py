"""The collectives of the parallel layer, over ``torch.distributed``.

Most are written with two operations only, ``all_reduce`` (sum) and
``broadcast``, which every backend carries for every device:

* an all_gather of rows is an all_reduce into a zero-filled buffer
  (``gather_rows``, ``gather_draws``), which moves up to twice the bytes
  of the dedicated collective.

The flat vectors of fsdp (``engine/optim.py::ShardedAdam``: mu, rho and
their Adam moments sharded at rest) go through ``all_gather_flat`` and
``reduce_scatter_flat``, which issue the dedicated operations
(``all_gather_into_tensor`` and ``reduce_scatter_tensor``, under their
newer names ``all_gather_single`` and ``reduce_scatter_single`` where the
installed torch has them) when the group's backend carries them for the
tensor's device: NCCL, or gloo on CPU tensors. Gloo carries neither for
CUDA tensors, and two ranks on one card can only talk through gloo (NCCL
refuses two ranks on one GPU); there the gather is an all_reduce into a
buffer filled with -0.0 (x + -0.0 is x for every x, signed zeros
included, so both formulations give the same bits) and the reduce-scatter
an all_reduce of the whole vector followed by a copy of this rank's
slice. The choice is made from the backend and the device
(``dedicated_ops``), never by trying one. The dedicated operations need
equal chunks and the fsdp shards are ragged (``parallel/mesh.py::
posterior_sharding``: the last shard short, trailing ones possibly
empty), so a shard is padded to the common chunk and the gather's buffer
of N chunks is cut to its first n elements. No collective is skipped or
retried on the CPU when it fails: the error propagates.

An ``Axis`` is one axis of the mesh as this rank sees it: its process
group, its size and this rank's index on it. An axis of size 1 makes every
collective here a no-op, so code written for a mesh runs unchanged
without a process group.

``bn_sync(axis)`` names the axis that train-mode BatchNorm reduces its
statistics over (``models/resnet.py::batch_norm``, DVP's
``engine/moment.py::batchnorm_moments``): the data axis, so the statistics
are the global batch's, as the JAX package's SPMD program computes them.
It is a module global, not a context variable, because the backward (and a
checkpointed chunk's re-forward) runs on the autograd engine's device
thread, which sees no context variable of the caller's.

``local_shards(N)`` is the axis of N data shards of one process, each run
by a thread of its own (``parallel/local_shards.py``), whose ops a
``torch.export`` program can hold where it cannot hold a collective
(serving.py's data-sharded artifacts): under its ``bn_sync`` the BN sums
go through ``auv::shard_sum``; on it ``gather_rows`` is one
``auv::shard_gather`` and ``own_rows`` one ``auv::shard_rows``. It
carries no other collective (``gather_draws``' backward and the
optimizer's sums are not for it).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# also registers torch.ops.auv.shard_sum, shard_gather and shard_rows
from multimodal_auv_torch.parallel import local_shards as _local_shards

# collectives this process issued, by kind; BatchNorm's forward reductions
# also count under "bn" (a checkpointed chunk's re-forward counts again)
COUNTS: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
                          "reduce_scatter": 0, "bn": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(frozen=True)
class Axis:
    """A mesh axis as this rank sees it. ``group`` None with ``size`` > 1
    is the default (world) group."""

    size: int = 1
    index: int = 0
    group: Any = None


LOCAL = Axis()
SHARD_ALIGN = 1024  # the JAX package's pad multiple: fsdp's chunk
# the group of a ``local_shards`` axis: threads of this process, not ranks
LOCAL_SHARDS = "local_shards"


def local_shards(n: int) -> Axis:
    """The axis of ``n`` data shards run by threads of this process (the
    shard's index is its thread's, ``local_shards.shard_context``)."""
    return Axis(size=int(n), group=LOCAL_SHARDS)


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """In-place sum over ``axis``; a no-op on an axis of size 1."""
    if axis.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
        COUNTS["all_reduce"] += 1
    return t


def broadcast_(t: torch.Tensor, src: int, axis: Axis) -> torch.Tensor:
    """In-place broadcast from global rank ``src``; a no-op on size 1."""
    if axis.size > 1:
        dist.broadcast(t, src=src, group=axis.group)
        COUNTS["broadcast"] += 1
    return t


def dedicated_ops(axis: Axis, t: torch.Tensor) -> bool:
    """Whether the group of ``axis`` carries ``all_gather_into_tensor``
    and ``reduce_scatter_tensor`` for tensors on ``t``'s device: NCCL, or
    gloo on the CPU (any other backend takes the all_reduce
    formulation)."""
    name = dist.get_backend(axis.group)
    return name == "nccl" or (name == "gloo" and t.device.type == "cpu")


def flat_chunk(n: int, size: int) -> int:
    """The equal chunk of a length-``n`` vector over ``size`` ranks:
    ``SHARD_ALIGN``-aligned, so rank i's slice is [i * chunk, (i + 1) *
    chunk) cut to n (``parallel/mesh.py::posterior_sharding``)."""
    return -(-n // (SHARD_ALIGN * size)) * SHARD_ALIGN


def flat_bounds(n: int, axis: Axis) -> Tuple[int, int]:
    """This rank's [lo, hi) of a length-``n`` vector over ``axis``."""
    per = flat_chunk(n, axis.size)
    return min(axis.index * per, n), min((axis.index + 1) * per, n)


def _padded(t: torch.Tensor, length: int) -> torch.Tensor:
    if t.numel() == length:
        return t.contiguous()
    out = t.new_zeros(length)
    out[:t.numel()] = t
    return out


def all_gather_flat(shard: torch.Tensor, axis: Axis, n: int) -> torch.Tensor:
    """The whole length-``n`` vector of which this rank holds
    ``flat_bounds(n, axis)`` as ``shard`` (1-D): a new tensor, not
    differentiable (``shard`` itself on an axis of size 1)."""
    if axis.size == 1:
        return shard
    gather = (_gather_dedicated if dedicated_ops(axis, shard)
              else _gather_by_sum)
    return gather(shard, axis, n)


def _gather_by_sum(shard: torch.Tensor, axis: Axis, n: int) -> torch.Tensor:
    lo, hi = flat_bounds(n, axis)
    out = torch.full((n,), -0.0, dtype=shard.dtype, device=shard.device)
    out[lo:hi] = shard
    return all_reduce_(out, axis)


def _gather_dedicated(shard: torch.Tensor, axis: Axis,
                      n: int) -> torch.Tensor:
    """``all_gather_flat`` through the backend's all_gather of equal
    chunks (on an axis of any size, one included)."""
    per = flat_chunk(n, axis.size)
    op = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    out = shard.new_empty(axis.size * per)
    op(out, _padded(shard, per), group=axis.group)
    COUNTS["all_gather"] += 1
    return out[:n]


def reduce_scatter_flat(full: torch.Tensor, axis: Axis,
                        bounds: Tuple[int, int]) -> torch.Tensor:
    """This rank's [lo, hi) = ``bounds`` (``flat_bounds``) of the sum over
    ``axis`` of every rank's length-n ``full`` (1-D), as a tensor of its
    own. On the all_reduce formulation ``full`` is summed in place (its
    values are spent); ``full[lo:hi]`` itself on an axis of size 1."""
    if axis.size == 1:
        return full[bounds[0]:bounds[1]]
    scatter = (_scatter_dedicated if dedicated_ops(axis, full)
               else _scatter_by_sum)
    return scatter(full, axis, bounds)


def _scatter_by_sum(full: torch.Tensor, axis: Axis,
                    bounds: Tuple[int, int]) -> torch.Tensor:
    lo, hi = bounds
    return all_reduce_(full, axis)[lo:hi].clone()


def _scatter_dedicated(full: torch.Tensor, axis: Axis,
                       bounds: Tuple[int, int]) -> torch.Tensor:
    """``reduce_scatter_flat`` through the backend's reduce-scatter of
    equal chunks (on an axis of any size, one included)."""
    lo, hi = bounds
    per = flat_chunk(full.numel(), axis.size)
    op = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    out = full.new_empty(per)
    op(out, _padded(full, axis.size * per), op=dist.ReduceOp.SUM,
       group=axis.group)
    COUNTS["reduce_scatter"] += 1
    return out if hi - lo == per else out[:hi - lo].clone()


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis whose backward sums the incoming gradient over the
    same axis, as SyncBatchNorm's: each rank's loss depends on every
    rank's rows through the summed statistics, so d(total loss)/d(local
    sum) is the sum of the ranks' gradients of the shared sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` as a new tensor, differentiable
    (its backward all-reduces the gradient)."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Concatenate every rank's ``x`` (equal shapes) along dimension 0 in
    axis order: an all_reduce into a zero-filled buffer (on a
    ``local_shards`` axis one ``auv::shard_gather``). Not
    differentiable."""
    if axis.size == 1:
        return x
    if axis.group == LOCAL_SHARDS:
        return torch.ops.auv.shard_gather(x, axis.size)
    n = x.shape[0]
    buf = x.new_zeros((axis.size * n,) + tuple(x.shape[1:]))
    buf[axis.index * n:(axis.index + 1) * n] = x
    return all_reduce_(buf, axis)


def own_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """This member's 1/size slice of ``x`` along ``dim``, the inverse of
    ``gather_rows``: a slice by ``axis.index`` on a process mesh, one
    ``auv::shard_rows`` on a ``local_shards`` axis (whose index is the
    worker thread's); ``x`` itself on an axis of size 1."""
    if axis.size == 1:
        return x
    if axis.group == LOCAL_SHARDS:
        return torch.ops.auv.shard_rows(x, axis.size, dim)
    return _local_shards.rows_of(x, axis.size, dim, axis.index)


class _GatherDraws(torch.autograd.Function):
    """``gather_rows`` whose backward hands each rank the gradient of its
    own slice, with no communication: every rank of the axis computes the
    same function of the gathered tensor, so the slice's gradient on its
    own rank is already the whole gradient of that slice."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        return gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.axis.index, ctx.n
        return g[i * n:(i + 1) * n], None


def gather_draws(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``gather_rows``, differentiable (see ``_GatherDraws``)."""
    if axis.size == 1:
        return x
    return _GatherDraws.apply(x, axis)


_BN_AXIS: Axis = LOCAL


@contextlib.contextmanager
def bn_sync(axis: Optional[Axis]):
    """BatchNorm statistics over ``axis`` (None: this rank's rows) inside
    the block, its backward included."""
    global _BN_AXIS
    prev, _BN_AXIS = _BN_AXIS, (axis or LOCAL)
    try:
        yield
    finally:
        _BN_AXIS = prev


def bn_synced() -> bool:
    """Whether BatchNorm's sums are summed over other ranks or shards here
    (the BN axis has more than one member)."""
    return _BN_AXIS.size > 1


def sync_sums(sums: torch.Tensor, count=None):
    """A BatchNorm layer's per-channel sums and their element count (a
    number or a 0-d tensor) over the BN axis: (sums, count), summed by one
    differentiable all_reduce of their concatenation (on a
    ``local_shards`` axis one ``auv::shard_sum``, not differentiable),
    counted under "bn"; returned as given on an axis of size 1."""
    axis = _BN_AXIS
    if axis.size == 1:
        return sums, count
    if not torch.compiler.is_compiling():
        # (a ``map`` body, which torch.export traces with dynamo, may not
        # write a global)
        COUNTS["bn"] += 1
    if axis.group == LOCAL_SHARDS:
        total = lambda t: torch.ops.auv.shard_sum(t, axis.size)
    else:
        total = lambda t: all_reduce_sum(t, axis)
    if count is None:
        return total(sums), None
    tot = total(torch.cat([sums, torch.as_tensor(
        count, dtype=sums.dtype, device=sums.device).reshape(1)]))
    return tot[:-1], tot[-1]
