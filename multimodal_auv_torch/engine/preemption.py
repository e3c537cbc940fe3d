"""Cooperative preemption handling for training runs (copied from
``multimodal_auv_tpu/engine/preemption.py``: pure Python, signal and
threading).

Cloud fleets preempt machines routinely: the platform delivers SIGTERM and
grants a short grace window before SIGKILL. Python's default SIGTERM
disposition kills the process wherever it happens to be — mid-epoch
(discarding up to an epoch of work with no log line) or in the middle of a
checkpoint write. The reference's only failure story is a bare-except
weight dump (its train/multimodal.py:194-200); this module is its
replacement on preemptible hardware.

``PreemptionGuard`` turns the signal into a cooperative stop:

* the handler only sets a flag (no I/O — logging is not
  async-signal-safe; the training loop logs when it observes the flag);
* train loops poll the flag each batch (``stop_check=guard.check``) and
  break at the next batch boundary;
* orchestrators then skip eval and the epoch-boundary checkpoint save
  for the partial epoch and drain in-flight async saves. The previous
  boundary checkpoint remains the resume point — and because per-epoch
  keys are folded from the base key by ABSOLUTE epoch index (loops.py),
  resuming replays the interrupted epoch bit-identically, as if the
  preemption never happened;
* a second signal escalates to ``KeyboardInterrupt`` for operators who
  need the process gone now (the orchestrators' ``finally`` still drains
  async saves on the way out).

Usage (the training pipelines do this by default,
``handle_preemption=True``)::

    with PreemptionGuard() as guard:
        train_and_evaluate_multimodal_model(..., preemption_guard=guard)
    if guard.triggered:
        ...log the resume command / exit 75...

Signal handlers can only be installed from the main thread; elsewhere
the guard degrades to a manual flag (``trigger()``) and logs a warning.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

#: Conventional "temporary failure, retry" exit code (BSD EX_TEMPFAIL):
#: schedulers treat it as "re-run me", which is exactly what a preempted
#: training run wants.
PREEMPTED_EXIT_CODE = 75


class PreemptionGuard:
    """Context manager converting SIGTERM (by default) into a polled flag.

    The handler is deliberately minimal — it sets ``triggered`` and
    counts deliveries. It never raises on the first signal (that would
    fire at an arbitrary bytecode boundary, e.g. inside a checkpoint
    write),
    and never logs (not async-signal-safe). A second delivery of any
    guarded signal raises ``KeyboardInterrupt``: the operator asked twice.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._installed = False
        self._count = 0
        self.triggered = False

    # -- signal plumbing ----------------------------------------------------

    def _on_signal(self, signum, frame):
        self._count += 1
        self.triggered = True
        if self._count >= 2:
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name}: stopping immediately")

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionGuard entered off the main thread: signal "
                "handlers NOT installed (only trigger() will stop the run)")
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._installed:
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
            self._installed = False
        return False

    # -- polling API ---------------------------------------------------------

    def check(self) -> bool:
        """``stop_check`` callable for the train loops."""
        return self.triggered

    def trigger(self) -> None:
        """Manually request a stop (tests; off-main-thread fallback)."""
        self.triggered = True


def null_guard() -> "PreemptionGuard":
    """A guard that never installs handlers and never triggers — lets
    call sites write ``guard.check`` / ``guard.triggered`` unconditionally."""
    g = PreemptionGuard(signals=())
    return g


def maybe_guard(enabled: bool) -> Optional[PreemptionGuard]:
    """``PreemptionGuard()`` when enabled, else a no-op ``null_guard()``
    (still a valid context manager, never installs handlers)."""
    return PreemptionGuard() if enabled else null_guard()
