"""ivtmetrics-parity recognition metrics (per-video AP over components).

The port's copy of ``metrics/recognition.py`` in the JAX package.

The reference depends on the external pip package ``ivtmetrics`` v0.0.6
(MT4MTLKD/environment.yaml:73) — usage sites: MT4MTLKD/Spatial_cnn/run.py:
331-338,426-448,543-548. This is a from-scratch numpy implementation whose
public surface and attribute protocol match the package as used by the
reference, including the internals the reference reaches into
(``targets``/``predictions``/``global_targets``/``global_predictions``,
see the local ``topk`` re-implementation at
MT4MTLKD/Temporal_mstct/run.py:507-523 which reads those attributes).

Semantics:

* ``update(targets, predictions)`` accumulates frames of the current video.
* ``video_end()`` closes the current video (appends to the global lists).
* ``compute_video_AP(component, ignore_null)``: per-class AP computed per
  video, nan-averaged across videos, then nan-averaged across classes
  ("video-wise mAP" — the north-star number).
* ``compute_global_AP``: AP over all frames of all videos concatenated.
* ``topK(k, component)``: global fraction of ground-truth positives that
  appear in the frame's top-k predictions (exact reference semantics above).
* Component disentanglement maps 100-d triplet scores onto component scores
  by max-aggregation via the bank (consistent with the reference's own
  component-max mapping, TERL/6_baseline_learnT/run.py:282-294).
* Average precision follows sklearn's step-interpolated definition with tie
  handling; classes without positives yield NaN (the reference silences the
  resulting divisions with np.seterr, Spatial_cnn/run.py:21,300).

ivtmetrics algorithm spec (transcribed; the package is not installable in
this offline container so these conventions are pinned by
tests/test_metrics.py edge cases instead of golden vectors):

* ivtmetrics 0.0.6 delegates per-class AP to
  ``sklearn.metrics.average_precision_score(..., average=None)`` — the
  uninterpolated sum AP = Σ (R_n − R_{n−1}) · P_n over distinct score
  thresholds, ties collapsed. ``average_precision`` below reproduces it
  (asserted against the installed sklearn for every positive-bearing
  class).
* No-positive classes: the reference's environment pins
  scikit-learn=1.0.2 (MT4MTLKD/environment.yaml:51), where the 0/0
  recall makes the column's AP NaN; every ivtmetrics aggregation is a
  ``np.nanmean``, so such classes are EXCLUDED from means. (sklearn ≥1.1
  changed this to return 0.0 with a warning — using the modern value
  would silently drag every video's mAP down, since most CholecT45
  classes are absent from most videos. We implement the 1.0.2/NaN
  convention.)
* compute_video_AP ordering: per-class AP per video -> nanmean over
  VIDEOS per class -> nanmean over CLASSES. This is NOT the mean of
  per-video mAPs: a class only contributes to videos where it has
  positives, and each class gets equal weight in the final mean
  regardless of how many videos contain it.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np

from ..data import bank as bank_mod

_COMPONENTS = ("ivt", "i", "v", "t", "iv", "it")


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Step-interpolated AP for one class; NaN when the class has no positives."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    total_pos = y_true.sum()
    if total_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    s = y_score[order]
    # collapse tied scores so precision/recall are evaluated per threshold
    distinct = np.where(np.diff(s) != 0)[0]
    idx = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[idx]
    n_at = idx + 1.0
    precision = tps / n_at
    recall = tps / total_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def classwise_ap(targets: np.ndarray, predictions: np.ndarray) -> np.ndarray:
    """(N, C) targets/scores -> (C,) per-class AP (NaN where no positives)."""
    C = targets.shape[1]
    return np.array(
        [average_precision(targets[:, c], predictions[:, c]) for c in range(C)],
        dtype=np.float64,
    )


class Recognition:
    """Per-video AP accumulator, API-compatible with ivtmetrics.Recognition."""

    def __init__(self, num_class: int = 100, bank: Optional[np.ndarray] = None):
        self.num_class = num_class
        self.bank = bank if bank is not None else bank_mod.load_bank()
        self.reset_global()

    # -- accumulation ------------------------------------------------------

    def reset(self) -> None:
        """Clear the current-video buffers."""
        self.predictions: List[np.ndarray] = []
        self.targets: List[np.ndarray] = []

    def reset_global(self) -> None:
        """Clear everything (all videos)."""
        self.global_predictions: List[np.ndarray] = []
        self.global_targets: List[np.ndarray] = []
        self.reset()

    def update(self, targets, predictions) -> None:
        """Append a batch of frames (any array-likes of shape (B, num_class))."""
        targets = np.asarray(targets, dtype=np.float64).reshape(-1, self.num_class)
        predictions = np.asarray(predictions, dtype=np.float64).reshape(-1, self.num_class)
        if targets.shape != predictions.shape:
            raise ValueError(
                f"targets {targets.shape} and predictions {predictions.shape}"
                " must align frame-for-frame (a mismatch silently corrupts"
                " per-video AP)")
        self.targets.append(targets)
        self.predictions.append(predictions)

    def video_end(self) -> None:
        """Close the current video and start a new one."""
        if self.targets:
            self.global_targets.append(np.concatenate(self.targets, axis=0))
            self.global_predictions.append(np.concatenate(self.predictions, axis=0))
        self.reset()

    # -- disentanglement ---------------------------------------------------

    def _extract(self, arr: np.ndarray, component: str) -> np.ndarray:
        """Map triplet-space arrays onto a component; identity for direct tasks."""
        if component not in _COMPONENTS:
            raise ValueError(f"component must be one of {_COMPONENTS}, got {component!r}")
        if arr.shape[1] != bank_mod.NUM_TRIPLET or component == "ivt":
            return arr
        col = bank_mod.COMPONENT_COLUMNS[component]
        ids = np.unique(self.bank[:, col])
        out = np.empty((arr.shape[0], len(ids)), dtype=arr.dtype)
        for j, cid in enumerate(ids):
            out[:, j] = arr[:, self.bank[:, col] == cid].max(axis=1)
        return out

    def _null_mask(self, width: int, component: str) -> np.ndarray:
        """Classes to drop under the challenge (ignore_null) protocol."""
        if width == bank_mod.NUM_TRIPLET or component != "ivt":
            comp = component
        elif width == bank_mod.NUM_VERB:
            comp = "v"
        elif width == bank_mod.NUM_TARGET:
            comp = "t"
        else:
            return np.zeros(width, dtype=bool)
        mask = bank_mod.null_component_mask(comp)
        if len(mask) != width:
            return np.zeros(width, dtype=bool)
        return mask

    # -- metrics -----------------------------------------------------------

    def _videos(self):
        """All closed videos plus the still-open one, as (targets, preds) pairs."""
        vids = list(zip(self.global_targets, self.global_predictions))
        if self.targets:
            vids.append((np.concatenate(self.targets, 0), np.concatenate(self.predictions, 0)))
        return vids

    def _result(self, classwise: np.ndarray, component: str, ignore_null: bool) -> Dict:
        if ignore_null:
            classwise = classwise[~self._null_mask(len(classwise), component)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            mean = float(np.nanmean(classwise)) if classwise.size else float("nan")
        return {"AP": classwise, "mAP": mean}

    def compute_AP(self, component: str = "ivt", ignore_null: bool = False) -> Dict:
        """AP of the current (open) video only."""
        if not self.targets:
            return self._result(np.full(self.num_class, np.nan), component, ignore_null)
        t = self._extract(np.concatenate(self.targets, 0), component)
        p = self._extract(np.concatenate(self.predictions, 0), component)
        return self._result(classwise_ap(t, p), component, ignore_null)

    def compute_video_AP(self, component: str = "ivt", ignore_null: bool = False) -> Dict:
        """Video-wise AP: per-class AP per video, nan-mean across videos."""
        per_video = []
        for t, p in self._videos():
            per_video.append(classwise_ap(self._extract(t, component),
                                          self._extract(p, component)))
        if not per_video:
            return self._result(np.full(self.num_class, np.nan), component, ignore_null)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            classwise = np.nanmean(np.stack(per_video, axis=0), axis=0)
        return self._result(classwise, component, ignore_null)

    def compute_global_AP(self, component: str = "ivt", ignore_null: bool = False) -> Dict:
        """AP over all frames of all videos concatenated."""
        vids = self._videos()
        if not vids:
            return self._result(np.full(self.num_class, np.nan), component, ignore_null)
        t = np.concatenate([v[0] for v in vids], axis=0)
        p = np.concatenate([v[1] for v in vids], axis=0)
        return self._result(classwise_ap(self._extract(t, component),
                                         self._extract(p, component)),
                            component, ignore_null)

    def topK(self, k: int = 5, component: str = "ivt") -> float:
        """Fraction of GT positives recovered in the top-k predictions per frame.

        Exact semantics of the reference's re-implementation
        (MT4MTLKD/Temporal_mstct/run.py:507-523).
        """
        vids = self._videos()
        if not vids:
            return 0.0
        targets = self._extract(np.concatenate([v[0] for v in vids], 0), component)
        predicts = self._extract(np.concatenate([v[1] for v in vids], 0), component)
        correct, total = 0.0, 0
        for gt, pd in zip(targets, predicts):
            gt_pos = np.nonzero(gt)[0]
            pd_idx = (-pd).argsort(kind="mergesort")[:k]
            correct += len(set(gt_pos).intersection(set(pd_idx)))
            total += len(gt_pos)
        if total == 0:
            total = 1
        return correct / total
