"""Cached-feature bus: the only coupling between pipeline stages.

The port's copy of ``data/feature_store.py`` in the JAX package: the same
pickle format and the same ``video_key`` rule, so both packages read each
other's artifacts.

The reference stages communicate exclusively through pickle files
``.../data_feats/run_<ver>/k<fold>_{i,v,t,}_{feats,pred}.pkl`` holding
``dict[two-char video id -> ndarray (T, D)]`` (writers e.g.
MT4MTLKD/Spatial_cnn/test.py:270-284, readers e.g.
MT4MTLKD/Temporal_mstct/dataloader.py:220-222).

This module makes that protocol a first-class artifact API:

* ``FeatureStore`` reads/writes the reference pickle format verbatim, so the
  TPU pipeline interoperates with features dumped by the reference.
* An ``.npz`` sibling format is provided for pure-numpy, mmap-friendly reads.

Keys are the reference's two-character video suffix ("VID01" -> "01",
dataloader.py:219 ``self.img_dir[-2:]``).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Optional

import numpy as np


def video_key(video: str) -> str:
    """'VID01' -> '01', 'VID110' -> '110'.

    The reference keys pickles by ``img_dir[-2:]`` (dataloader.py:219) which
    COLLIDES for the 3-digit CholecT50 ids (VID110 -> '10' == VID10) — fine
    for its CholecT45 experiments, silently corrupting for cholect50
    variants. We key by the full id (identical to the reference for 2-digit
    ids, unique for 3-digit ones).
    """
    return video[3:] if video.startswith("VID") else video[-2:]


def artifact_name(fold: int, kind: str, task: str = "") -> str:
    """File stem, e.g. (1, 'feats', 'i') -> 'k1_i_feats'; (1, 'feats') -> 'k1_feats'."""
    if kind not in ("feats", "pred"):
        raise ValueError(f"kind must be 'feats' or 'pred', got {kind!r}")
    parts = [f"k{fold}"] + ([task] if task else []) + [kind]
    return "_".join(parts)


class FeatureStore:
    """One run-version directory of cached per-video feature/pred arrays."""

    def __init__(self, root: str, version: str, fmt: str = "pkl"):
        if fmt not in ("pkl", "npz"):
            raise ValueError(f"fmt must be 'pkl' or 'npz', got {fmt!r}")
        self.dir = os.path.join(root, f"run_{version}")
        self.fmt = fmt

    def path(self, fold: int, kind: str, task: str = "") -> str:
        return os.path.join(self.dir, artifact_name(fold, kind, task) + "." + self.fmt)

    def save(self, fold: int, kind: str, data: Dict[str, np.ndarray], task: str = "") -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = self.path(fold, kind, task)
        data = {video_key(k): np.asarray(v) for k, v in data.items()}
        if self.fmt == "pkl":
            with open(path, "wb") as f:
                pickle.dump(data, f)
        else:
            np.savez(path, **data)
        return path

    def load(self, fold: int, kind: str, task: str = "",
             videos: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
        path = self.path(fold, kind, task)
        if self.fmt == "pkl":
            with open(path, "rb") as f:
                data = pickle.load(f)
        else:
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
        if videos is not None:
            keys = [video_key(v) for v in videos]
            data = {k: data[k] for k in keys}
        return data

    def load_video(self, fold: int, kind: str, video: str, task: str = "") -> np.ndarray:
        return self.load(fold, kind, task)[video_key(video)]
