"""Per-class instance counts and the tail classes (TERL's ins_num.txt).

The port's copy of ``computervision_codes_tpu/data/tail_stats.py`` and of
its ``ins_num.txt``: dataset statistics shipped with the reference
(TERL/6_baseline_learnT/ins_num.txt, parsed at run.py:183-205),
tab-separated ``class_id\\tcount`` rows by descending count in four
sections: 6 instruments, 10 verbs, 15 targets, 100 triplets. The default
tail set is the ``tail_num`` rarest triplet ids (run.py:204-205, 84).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Sequence

import numpy as np

_PATH = os.path.join(os.path.dirname(__file__), "ins_num.txt")
_SECTIONS = (("i", 6), ("v", 10), ("t", 15), ("ivt", 100))


@functools.lru_cache(maxsize=None)
def instance_counts(path: str = _PATH) -> Dict[str, np.ndarray]:
    """task -> (N, 2) [class_id, count] rows by descending count."""
    rows = np.loadtxt(path, dtype=np.int64, delimiter="\t")
    out: Dict[str, np.ndarray] = {}
    start = 0
    for task, n in _SECTIONS:
        out[task] = rows[start:start + n]
        start += n
    if start != len(rows):
        raise ValueError(f"ins_num at {path}: expected {start} rows, "
                         f"got {len(rows)}")
    return out


def tail_triplet_classes(tail_num: int = 84,
                         explicit: Sequence[int] = ()) -> List[int]:
    """The ``tail_num`` rarest triplet ids, or the ``explicit`` list."""
    if explicit:
        return list(explicit)
    ivt = instance_counts()["ivt"]
    return [int(c) for c in ivt[-tail_num:, 0]]


def class_counts_sorted_by_id(task: str) -> np.ndarray:
    """(N,) counts indexed by class id (run.py:190-199)."""
    rows = instance_counts()[task]
    return rows[np.argsort(rows[:, 0]), 1]
