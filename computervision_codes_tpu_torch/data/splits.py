"""CholecT45/CholecT50 dataset variants and official video-id split tables.

The port's copy of ``data/splits.py`` in the JAX package.

The split tables are dataset facts published with the CholecT45/50 releases
(reference: MT4MTLKD/Spatial_cnn/dataloader.py:112-148). Selection semantics
match the reference exactly (dataloader.py:74-88):

* ``*-crossval`` variants: train = concatenation of all folds except the test
  fold (in fold order 1..5), test = the held-out fold, val = the **last 5**
  train videos (removed from train).
* non-crossval variants: fixed train/val/test lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

VARIANTS = (
    "cholect50",
    "cholect50-challenge",
    "cholect45-challenge",
    "cholect45-crossval",
    "cholect50-crossval",
    "cholect45",  # alias of cholect45-crossval
)

_FIXED_SPLITS: Dict[str, Dict[str, List[int]]] = {
    "cholect50": {
        "train": [1, 15, 26, 40, 52, 65, 79, 2, 18, 27, 43, 56, 66, 92, 4, 22,
                  31, 47, 57, 68, 96, 5, 23, 35, 48, 60, 70, 103, 13, 25, 36,
                  49, 62, 75, 110],
        "val": [8, 12, 29, 50, 78],
        "test": [6, 51, 10, 73, 14, 74, 32, 80, 42, 111],
    },
    "cholect50-challenge": {
        "train": [1, 15, 26, 40, 52, 79, 2, 27, 43, 56, 66, 4, 22, 31, 47, 57,
                  68, 23, 35, 48, 60, 70, 13, 25, 49, 62, 75, 8, 12, 29, 50,
                  78, 6, 51, 10, 73, 14, 32, 80, 42],
        "val": [5, 18, 36, 65, 74],
        "test": [92, 96, 103, 110, 111],
    },
    "cholect45-challenge": {
        "train": [1, 15, 26, 40, 52, 79, 2, 27, 43, 56, 66, 4, 22, 31, 47, 57,
                  5, 23, 35, 48, 60, 18, 13, 25, 49, 62, 65, 8, 12, 29, 50, 78,
                  6, 51, 10, 36, 14, 32, 80, 42],
        "val": [68, 70, 73, 74, 75],
        "test": [92, 96, 103, 110, 111],
    },
}

_CROSSVAL_FOLDS: Dict[str, Dict[int, List[int]]] = {
    "cholect45-crossval": {
        1: [79, 2, 51, 6, 25, 14, 66, 23, 50],
        2: [80, 32, 5, 15, 40, 47, 26, 48, 70],
        3: [31, 57, 36, 18, 52, 68, 10, 8, 73],
        4: [42, 29, 60, 27, 65, 75, 22, 49, 12],
        5: [78, 43, 62, 35, 74, 1, 56, 4, 13],
    },
    "cholect50-crossval": {
        1: [79, 2, 51, 6, 25, 14, 66, 23, 50, 111],
        2: [80, 32, 5, 15, 40, 47, 26, 48, 70, 96],
        3: [31, 57, 36, 18, 52, 68, 10, 8, 73, 103],
        4: [42, 29, 60, 27, 65, 75, 22, 49, 12, 110],
        5: [78, 43, 62, 35, 74, 1, 56, 4, 13, 92],
    },
}


def video_name(vid: int) -> str:
    """Format a video id as the directory/file stem, e.g. 1 -> 'VID01'."""
    return "VID{}".format(str(vid).zfill(2))


@dataclass(frozen=True)
class Split:
    """Resolved train/val/test video-name lists for one dataset variant."""

    variant: str
    test_fold: int
    train: Tuple[str, ...]
    val: Tuple[str, ...]
    test: Tuple[str, ...]

    @property
    def all_videos(self) -> Tuple[str, ...]:
        # Order matches the reference all-video dump loaders
        # (Spatial_cnn/dataloader_test.py:87-88): train + test + val.
        return self.train + self.test + self.val


def resolve_split(variant: str, test_fold: int = 1) -> Split:
    """Resolve a dataset variant (+ fold for crossval) to video-name splits."""
    if variant == "cholect45":
        variant = "cholect45-crossval"
    if variant not in VARIANTS:
        raise ValueError(f"unknown dataset variant {variant!r}; one of {VARIANTS}")
    if "crossval" in variant:
        folds = _CROSSVAL_FOLDS[variant]
        if test_fold not in folds:
            raise ValueError(f"test_fold must be in {sorted(folds)}, got {test_fold}")
        train: List[int] = []
        for k in folds:
            if k != test_fold:
                train.extend(folds[k])
        test = list(folds[test_fold])
        val = train[-5:]
        train = train[:-5]
    else:
        table = _FIXED_SPLITS[variant]
        train, val, test = table["train"], table["val"], table["test"]
        test_fold = 0
    return Split(
        variant=variant,
        test_fold=test_fold,
        train=tuple(video_name(v) for v in train),
        val=tuple(video_name(v) for v in val),
        test=tuple(video_name(v) for v in test),
    )


def crossval_folds(variant: str = "cholect45-crossval") -> Sequence[int]:
    return tuple(sorted(_CROSSVAL_FOLDS[variant]))
