"""Preemption-safe training: checkpoint-and-exit on SIGTERM/SIGINT.

The port's copy of ``PreemptionGuard`` from ``utils/preempt.py`` in the
JAX package. Its ``install_preemption_guard``, which never restores the
handlers, is left out: the port's driver may run inside a process that
goes on (a test, a smoke run), so it holds the guard in a with-block.

A signal only sets a flag; the training loop checks it at the next batch
boundary, saves ``_latest`` (written to a temporary name and renamed, so a
hard kill never corrupts the previous checkpoint) and returns, and
``--resume`` continues from there. ``result["preempted"]`` tells the
caller the run is partial.
"""

from __future__ import annotations

import signal
from typing import Sequence


class PreemptionGuard:
    """Context manager: listed signals set ``requested`` instead of killing
    the process; previous handlers are restored on exit. Install in the
    main thread (CPython's signal rule)."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # not the main thread (e.g. a test harness): a guard that
                # never fires rather than a crashed driver
                self._prev.pop(s, None)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

