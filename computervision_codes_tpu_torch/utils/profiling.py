"""Profiling and timing hooks.

Counterpart of ``utils/profiling.py`` in the JAX package (whose ``trace``
wraps the JAX profiler and whose timers wait with ``block_until_ready``;
the reference disables torch's profilers at every driver's start-up,
Spatial_cnn/run.py:301-303):

* ``trace(log_dir)`` runs ``torch.profiler.profile`` over the block, with
  the CPU activity and, where CUDA is available, the CUDA one, and writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  chrome://tracing) into ``log_dir``; the profile is the context's value;
* ``timed`` and ``StepTimer.phase`` read the host clock; a result given to
  them (``t.result``, or ``result=``) is waited for first: every CUDA
  tensor in it has its device synchronised. A CPU tensor is ready when it
  is returned.

Usage::

    with trace("/tmp/torch-trace"):
        train_step(state, batch)

    with timed("train_step") as t:
        t.result = train_step(state, batch)
    print(t.seconds)
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; its Chrome trace is written to
    ``<log_dir>/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def block_until_ready(tree) -> None:
    """Wait for every CUDA tensor in ``tree`` (tensors in dicts, lists and
    tuples): each one's device is synchronised once."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for device in devices:
        torch.cuda.synchronize(device)


@dataclass
class _Timer:
    name: str
    seconds: float = 0.0
    result: Optional[object] = None


@contextlib.contextmanager
def timed(name: str = ""):
    """Host-clock timer; a result set as ``t.result`` inside the block is
    waited for before the clock is read."""
    t = _Timer(name)
    start = time.perf_counter()
    try:
        yield t
    finally:
        if t.result is not None:
            block_until_ready(t.result)
        t.seconds = time.perf_counter() - start


@dataclass
class StepTimer:
    """Mean host time per named phase across steps."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                block_until_ready(result)
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}
