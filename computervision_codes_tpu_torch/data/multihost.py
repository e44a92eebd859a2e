"""Multi-host input sharding: each rank's share of the videos and batch.

The port's copy of ``data/multihost.py`` in the JAX package. The reference
is single-process (its DDP/NCCL helpers are dead stubs, TERL/
6_baseline_learnT/models/moco.py:409-421), so its loaders read every
video. Here each rank (one process per device, ``parallel.mesh.launch``)
reads only its part, and every function is deterministic in
(process_index, process_count), so that the ranks agree without talking:

* ``shard_videos``      — the video list over ranks, balanced by frame
                          counts when known (LPT greedy), else round-robin;
* ``local_batch_size``  — the rank's share of the global batch;
* ``form_global_batch`` — the rank's batch leaves as tensors on its device.

torch has no global array: the global batch is the concatenation, in rank
order over the ``data`` group, of what ``form_global_batch`` returns on
each rank (JAX's ``make_array_from_process_local_data`` makes it one
array). A single process is the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def shard_videos(videos: Sequence[str], process_index: int,
                 process_count: int,
                 frame_counts: Optional[Dict[str, int]] = None) -> List[str]:
    """Deterministic partition of ``videos`` over ranks.

    With ``frame_counts`` the assignment is longest-processing-time greedy
    (sort by frames descending, give each video to the currently lightest
    rank), which keeps epochs even when lengths vary by 10x, as in
    CholecT45. Without counts it is round-robin. Every video goes to
    exactly one rank.
    """
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range "
                         f"for process_count {process_count}")
    if frame_counts is None:
        return [v for i, v in enumerate(videos)
                if i % process_count == process_index]
    missing = [v for v in videos if v not in frame_counts]
    if missing:
        raise ValueError(
            f"frame_counts missing {len(missing)} video(s): "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''} — pass "
            f"complete counts or frame_counts=None for round-robin")
    order = sorted(videos, key=lambda v: (-frame_counts[v], v))
    loads = [0] * process_count
    mine: List[str] = []
    for v in order:
        h = int(np.argmin(loads))
        loads[h] += frame_counts[v]
        if h == process_index:
            mine.append(v)
    return mine


def local_batch_size(global_batch: int, process_index: int,
                     process_count: int) -> int:
    """The rank's share of the global batch, which must divide evenly."""
    del process_index
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{process_count} hosts")
    return global_batch // process_count


def form_global_batch(mesh, batch: Dict[str, np.ndarray],
                      axis: str = "data") -> Dict[str, torch.Tensor]:
    """This rank's leaves (leading dim its ``local_batch_size``) as tensors
    on its device; the global batch is their concatenation over ``axis``
    of ``mesh`` in rank order."""
    from ..parallel.mesh import AXES, mesh_device

    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}")
    device = mesh_device(mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
