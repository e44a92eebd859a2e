"""Triplet -> component ("bank") mapping for the 100 CholecT triplet classes.

The port's copy of ``data/bank.py`` in the JAX package, with its own copy
of ``maps.txt`` beside it (the port imports nothing of the JAX package).

Each row of ``maps.txt`` is ``ivt, i, v, t, iv, it`` — the triplet class id
followed by its instrument / verb / target / instrument-verb /
instrument-target component class ids. This is dataset metadata shipped with
CholecT45 (reference copies live at e.g. MT4MTLKD/Spatial_cnn/maps.txt and
TERL/6_baseline_learnT/maps.txt; format documented in SURVEY.md §2 M13).

Component columns and class counts:
  col 0: ivt (100)   col 1: i (6)   col 2: v (10)   col 3: t (15)
  col 4: iv (pair ids present in the dataset)
  col 5: it (pair ids present in the dataset)
"""

from __future__ import annotations

import functools
import os

import numpy as np

COMPONENT_COLUMNS = {"ivt": 0, "i": 1, "v": 2, "t": 3, "iv": 4, "it": 5}

NUM_TOOL = 6
NUM_VERB = 10
NUM_TARGET = 15
NUM_TRIPLET = 100

# Null component class ids (CholecT45 label dictionary: verb 9 = null_verb,
# target 14 = null_target; instruments have no null class).
NULL_VERB = 9
NULL_TARGET = 14

_MAPS_PATH = os.path.join(os.path.dirname(__file__), "maps.txt")


@functools.lru_cache(maxsize=None)
def load_bank(path: str = _MAPS_PATH) -> np.ndarray:
    """Load the (100, 6) int component map."""
    bank = np.genfromtxt(path, dtype=int, comments="#", delimiter=",")
    if bank.shape != (NUM_TRIPLET, 6):
        raise ValueError(f"bank at {path} has shape {bank.shape}, expected (100, 6)")
    return bank


@functools.lru_cache(maxsize=None)
def component_class_ids(component: str) -> np.ndarray:
    """Sorted unique class ids of a component present in the bank."""
    bank = load_bank()
    col = COMPONENT_COLUMNS[component]
    return np.unique(bank[:, col])


@functools.lru_cache(maxsize=None)
def component_projection(component: str) -> np.ndarray:
    """Binary (100, C) matrix: proj[t, c] = 1 iff triplet t maps to class c.

    Used both for the metric disentanglement (max-aggregation of triplet
    scores into component scores) and for the TERL component-max logits
    (reference TERL/6_baseline_learnT/run.py:282-294 does an explicit
    ``torch.max(logit_ivt[:, idxes])`` python loop; here it is one masked
    segment-max that XLA fuses).
    """
    bank = load_bank()
    col = COMPONENT_COLUMNS[component]
    ids = component_class_ids(component)
    proj = np.zeros((bank.shape[0], len(ids)), dtype=np.float32)
    for j, cid in enumerate(ids):
        proj[bank[:, col] == cid, j] = 1.0
    return proj


def null_component_mask(component: str) -> np.ndarray:
    """Boolean mask over component classes that are 'null' (challenge eval).

    For components the null classes are null_verb / null_target; for pair and
    triplet components a class is null when its verb or target part is null.
    """
    bank = load_bank()
    ids = component_class_ids(component)
    if component == "i":
        return np.zeros(len(ids), dtype=bool)
    if component == "v":
        return ids == NULL_VERB
    if component == "t":
        return ids == NULL_TARGET
    col = COMPONENT_COLUMNS[component]
    is_null_triplet = (bank[:, COMPONENT_COLUMNS["v"]] == NULL_VERB) | (
        bank[:, COMPONENT_COLUMNS["t"]] == NULL_TARGET
    )
    mask = np.zeros(len(ids), dtype=bool)
    for j, cid in enumerate(ids):
        rows = bank[:, col] == cid
        # a component class is null iff every triplet mapping to it is null
        mask[j] = bool(np.all(is_null_triplet[rows]))
    return mask
