"""Data shards of one process: the ops ``auv::shard_sum``,
``auv::shard_gather`` and ``auv::shard_rows``, which a program run by N
threads, each on one data shard of a batch, calls where a mesh rank calls
a collective (serving.py's data-sharded artifacts).

Train-mode BatchNorm normalises over the global batch, so a batch split
over N shards needs the sum of the shards' per-channel sums inside every
BN layer; DVP (``engine/moment.py``) draws its features for the whole
batch and keeps its own rows after the head. A ``torch.export`` program
holds no collective, and a shard's index is its thread's at serving time,
not a constant at trace time, so the exported per-shard program calls
these ops (``parallel/collectives.py``: ``sync_sums`` under
``bn_sync(local_shards(N))``, ``gather_rows`` and ``own_rows`` on a
``local_shards`` axis). At serving time N worker threads run the N
shards' programs at once; each thread sets its shard context
(``shard_context``: its ``ShardGroup`` and its index):

* ``shard_sum(x, N)``: the sum of the shards' ``x`` in shard order;
* ``shard_gather(x, N)``: the shards' ``x`` concatenated along dimension
  0 in shard order;
* ``shard_rows(x, N, dim)``: this shard's 1/N slice of ``x`` along
  ``dim``. It meets no one.

The first two meet the other shards (``ShardGroup._meet``): shard i writes
its tensor into slot i and waits at a barrier for all N; it combines the
slots in shard order 0..N-1, each copied to its own device, so every shard
gets the same result bit for bit; it waits at a second barrier before any
slot can be written again.

Both barriers have a timeout. A worker that fails calls ``abort`` on its
groups, so the other shards raise ``threading.BrokenBarrierError`` at once
instead of waiting. No op falls back to the local tensor: outside a shard
context, or in a group of another size, each raises.

The shards' Python takes turns (``Turn``): a worker runs its program only
while it holds the turn, and gives it up inside an op while it waits for
the others. PyTorch releases the GIL in every op call, so two workers
running at once hand the GIL over at every op (tens of thousands of
handovers a batch, which made one b4 x 20 batch 6.5x slower than the
unsharded artifact's on an H100); in turns, each shard's dispatch runs
alone and the device still runs every queued kernel asynchronously.

Each op's fake implementation (the output's shape alone) is what
``torch.export`` traces, so tracing runs no rendezvous.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

# seconds a shard waits for the others at one rendezvous
DEFAULT_TIMEOUT = 300.0

_CTX = threading.local()

# rendezvous completed (shard 0 of each group counts its calls)
COUNTS = {"rendezvous": 0}


class ShardGroup:
    """The N shards that meet in ``auv::shard_sum`` and
    ``auv::shard_gather``: one slot per shard and two reusable barriers.
    Every shard must call the ops the same number of times, in the same
    order (the same program)."""

    def __init__(self, size: int, timeout: float = DEFAULT_TIMEOUT):
        self.size = int(size)
        self._slots = [None] * self.size
        self._filled = threading.Barrier(self.size, timeout=timeout)
        self._read = threading.Barrier(self.size, timeout=timeout)

    def abort(self) -> None:
        """Break both barriers: every shard waiting there, or arriving
        later, raises ``threading.BrokenBarrierError``."""
        self._filled.abort()
        self._read.abort()

    def _meet(self, index: int, x: torch.Tensor, combine: Callable,
              turn: Optional["Turn"]) -> torch.Tensor:
        """``combine`` of every shard's ``x`` in shard order, each copied
        to ``x``'s device. ``turn``: given up while the shards meet, taken
        again before returning."""
        self._slots[index] = x
        if turn is not None:
            turn.give()
        self._filled.wait()
        try:
            out = combine([s.to(x.device) for s in self._slots])
        except BaseException:
            self.abort()
            raise
        # no shard may write its next slot before every shard has read
        self._read.wait()
        if turn is not None:
            turn.take()
        return out

    def sum(self, index: int, x: torch.Tensor,
            turn: Optional["Turn"] = None) -> torch.Tensor:
        """The sum of every shard's ``x`` in shard order, on ``x``'s device:
        a new tensor, the same bits on every shard."""
        return self._meet(index, x, _sum_in_order, turn)

    def gather(self, index: int, x: torch.Tensor,
               turn: Optional["Turn"] = None) -> torch.Tensor:
        """Every shard's ``x`` (equal shapes) concatenated along dimension
        0 in shard order, on ``x``'s device."""
        return self._meet(index, x, torch.cat, turn)


def _sum_in_order(slots):
    total = slots[0]
    for s in slots[1:]:
        total = total + s
    return total


class Turn:
    """One worker at a time runs Python: ``take`` waits (with a timeout)
    for the turn, ``give`` hands it on if this thread holds it."""

    def __init__(self, timeout: float = DEFAULT_TIMEOUT):
        self.timeout = timeout
        self._lock = threading.Lock()
        self._owner = None

    def take(self) -> None:
        if not self._lock.acquire(timeout=self.timeout):
            raise TimeoutError(f"a data shard waited {self.timeout} s for "
                               f"its turn")
        self._owner = threading.get_ident()

    def give(self) -> None:
        if self._owner == threading.get_ident():
            self._owner = None
            self._lock.release()


@contextlib.contextmanager
def shard_context(group: ShardGroup, index: int,
                  turn: Optional[Turn] = None):
    """Run the block as shard ``index`` of ``group`` (this thread only),
    the op giving up ``turn`` while the shards meet."""
    if not 0 <= index < group.size:
        raise ValueError(f"shard index {index} outside a group of "
                         f"{group.size}")
    prev = getattr(_CTX, "shard", None)
    _CTX.shard = (group, index, turn)
    try:
        yield
    finally:
        _CTX.shard = prev


def current_shard() -> Optional[tuple]:
    """This thread's (group, index, turn), or None outside a shard
    context."""
    return getattr(_CTX, "shard", None)


def _shard(op: str, nshards: int) -> tuple:
    """This thread's (group, index, turn) for ``op`` over ``nshards``
    shards; raises outside a shard context or in a group of another
    size."""
    ctx = current_shard()
    if ctx is None:
        raise RuntimeError(
            f"auv::{op} outside a data shard: a data-sharded program runs "
            f"only in the loader's shard workers (serving.py), which meet "
            f"there over the shards")
    if ctx[0].size != nshards:
        raise RuntimeError(f"auv::{op} over {nshards} shards in a group of "
                           f"{ctx[0].size}")
    return ctx


def _counted(index: int, out: torch.Tensor) -> torch.Tensor:
    if index == 0:
        COUNTS["rendezvous"] += 1
    return out


@torch.library.custom_op("auv::shard_sum", mutates_args=())
def shard_sum(x: torch.Tensor, nshards: int) -> torch.Tensor:
    """The sum of ``x`` over the ``nshards`` data shards of this thread's
    group (module docstring). One implementation for every device."""
    group, index, turn = _shard("shard_sum", nshards)
    return _counted(index, group.sum(index, x, turn))


@shard_sum.register_fake
def _shard_sum_fake(x, nshards):
    return torch.empty_like(x)


@torch.library.custom_op("auv::shard_gather", mutates_args=())
def shard_gather(x: torch.Tensor, nshards: int) -> torch.Tensor:
    """``x`` of the ``nshards`` data shards of this thread's group,
    concatenated along dimension 0 in shard order (module docstring). One
    implementation for every device."""
    group, index, turn = _shard("shard_gather", nshards)
    return _counted(index, group.gather(index, x, turn))


@shard_gather.register_fake
def _shard_gather_fake(x, nshards):
    return x.new_empty((nshards * x.shape[0],) + tuple(x.shape[1:]))


def rows_of(x: torch.Tensor, nshards: int, dim: int,
            index: int) -> torch.Tensor:
    """Shard ``index``'s 1/``nshards`` slice of ``x`` along ``dim`` (a
    view)."""
    n = x.shape[dim] // nshards
    return x.narrow(dim, index * n, n)


@torch.library.custom_op("auv::shard_rows", mutates_args=())
def shard_rows(x: torch.Tensor, nshards: int, dim: int) -> torch.Tensor:
    """This thread's shard's 1/``nshards`` slice of ``x`` along ``dim``
    (a copy: an op's output may not alias its input). It meets no one."""
    _, index, _ = _shard("shard_rows", nshards)
    if x.shape[dim] % nshards:
        raise ValueError(f"auv::shard_rows: dimension {dim} of size "
                         f"{x.shape[dim]} over {nshards} shards")
    return rows_of(x, nshards, dim, index).clone()


@shard_rows.register_fake
def _shard_rows_fake(x, nshards, dim):
    shape = list(x.shape)
    shape[dim] = shape[dim] // nshards
    return x.new_empty(shape)
