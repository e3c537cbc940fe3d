"""Data shards of one process: the op ``auv::shard_sum``, which sums a
BatchNorm layer's statistics over N threads that each run one data shard
of a batch (serving.py's data-sharded artifacts).

Train-mode BatchNorm normalises over the global batch, so a batch split
over N shards needs the sum of the shards' per-channel sums inside every
BN layer. A ``torch.export`` program holds no collective, so the exported
per-shard program calls this op where a mesh rank calls ``all_reduce``
(``parallel/collectives.py::sync_sums`` under ``bn_sync(local_shards(N))``).
At serving time N worker threads run the N shards' programs at once; each
thread sets its shard context (``shard_context``: its ``ShardGroup`` and
its index) and the op meets the other shards there:

* shard i writes its tensor into slot i and waits at a barrier for all N;
* it sums the slots in shard order 0..N-1, each copied to its own device,
  so every shard gets the same total bit for bit;
* it waits at a second barrier before any slot can be written again.

Both barriers have a timeout. A worker that fails calls ``abort`` on its
groups, so the other shards raise ``threading.BrokenBarrierError`` at once
instead of waiting. The op never returns the local sums alone: outside a
shard context, or in a group of another size, it raises.

The shards' Python takes turns (``Turn``): a worker runs its program only
while it holds the turn, and gives it up inside the op while it waits for
the others. PyTorch releases the GIL in every op call, so two workers
running at once hand the GIL over at every op (tens of thousands of
handovers a batch, which made one b4 x 20 batch 6.5x slower than the
unsharded artifact's on an H100); in turns, each shard's dispatch runs
alone and the device still runs every queued kernel asynchronously.

The fake implementation (``torch.empty_like``) is what ``torch.export``
traces, so tracing runs no rendezvous.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

# seconds a shard waits for the others at one rendezvous
DEFAULT_TIMEOUT = 300.0

_CTX = threading.local()

# rendezvous completed (shard 0 of each group counts its calls)
COUNTS = {"rendezvous": 0}


class ShardGroup:
    """The N shards that meet in ``auv::shard_sum``: one slot per shard and
    two reusable barriers. Every shard must call the op the same number of
    times, in the same order (one call per BatchNorm layer of the same
    program)."""

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

    def sum(self, index: int, x: torch.Tensor,
            turn: Optional["Turn"] = None) -> torch.Tensor:
        """The sum of every shard's ``x`` in shard order, on ``x``'s device:
        a new tensor, the same bits on every shard. ``turn``: given up
        while the shards meet, taken again before returning."""
        self._slots[index] = x
        if turn is not None:
            turn.give()
        self._filled.wait()
        try:
            total = self._slots[0].to(x.device)
            for s in self._slots[1:]:
                total = total + s.to(x.device)
        except BaseException:
            self.abort()
            raise
        # no shard may write its next slot before every shard has read
        self._read.wait()
        if turn is not None:
            turn.take()
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


@torch.library.custom_op("auv::shard_sum", mutates_args=())
def shard_sum(x: torch.Tensor, nshards: int) -> torch.Tensor:
    """The sum of ``x`` over the ``nshards`` data shards of this thread's
    group (module docstring). One implementation for every device."""
    ctx = current_shard()
    if ctx is None:
        raise RuntimeError(
            "auv::shard_sum outside a data shard: a data-sharded program "
            "runs only in the loader's shard workers (serving.py), which "
            "sum its BatchNorm statistics over the shards")
    group, index, turn = ctx
    if group.size != nshards:
        raise RuntimeError(f"auv::shard_sum over {nshards} shards in a group "
                           f"of {group.size}")
    total = group.sum(index, x, turn)
    if index == 0:
        COUNTS["rendezvous"] += 1
    return total


@shard_sum.register_fake
def _shard_sum_fake(x, nshards):
    return torch.empty_like(x)
