"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package's.

* ``trace`` writes a Chrome trace of the block into its directory, whose
  events name the operations the block ran (here the CPU's; on the card
  the CUDA kernels too, which ``chip_smoke.py`` reads), as JAX's writes
  its profile into its directory.
* ``timed`` and ``StepTimer`` measure as JAX's do: the block's host time,
  waiting for ``t.result`` / ``result=`` first; ``summary`` is the mean
  per phase, and both packages give the same phases and counts for the
  same calls.
"""

import json
import time

import numpy as np
import pytest
import torch

from computervision_codes_tpu.utils import profiling as jax_profiling
from computervision_codes_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    assert prof is not None
    path = tmp_path / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]


@pytest.mark.parametrize("module", [profiling, jax_profiling],
                         ids=["port", "jax"])
def test_timed_waits_for_its_result(module):
    with module.timed("sleep") as t:
        time.sleep(0.01)
        t.result = torch.ones(3) if module is profiling else np.ones(3)
    assert t.name == "sleep" and t.seconds >= 0.01
    with module.timed() as t:
        pass
    assert 0 <= t.seconds < 0.01 and t.result is None


def test_step_timer_matches_jax():
    timers = [profiling.StepTimer(), jax_profiling.StepTimer()]
    for timer in timers:
        for step in range(3):
            with timer.phase("data"):
                time.sleep(0.002)
            with timer.phase("step", result=np.ones(2) if timer is timers[1]
                             else torch.ones(2)):
                time.sleep(0.001 * (step + 1))
    port, jax_ = timers
    assert port.counts == jax_.counts == {"data": 3, "step": 3}
    assert set(port.summary()) == set(jax_.summary()) == {"data", "step"}
    for k, v in port.summary().items():
        assert v == pytest.approx(port.totals[k] / 3)
        assert v >= 0.002  # data sleeps 2 ms, step 1-3 ms (2 ms mean)


def test_block_until_ready_walks_trees():
    """CPU tensors are ready when returned: nothing to wait for, in any
    tree (the CUDA branch synchronises each device once)."""
    profiling.block_until_ready({"a": [torch.ones(1), (torch.zeros(2),)],
                                 "b": None, "c": 3})
