"""Temporal-stage data: cached-feature sequences + labels, TPU-static shapes.

Feeds the TCN/MS-TCT stages from the feature bus. Parity targets:
  * feature+label alignment and loading (MT4MTLKD/Temporal_tenco/
    dataloader.py:200-233, TERL/0_5fold_TCN_black/dataloader.py:243-284);
  * black/frozen-frame dedup: drop BOTH frames of every consecutive pair
    whose feature delta sums to 0 (0_5fold_TCN_black/dataloader.py:252-257);
  * train-time clip sampling: 30% full video, else a random contiguous
    10..min(1000, T)-frame clip (dataloader.py:271-276);
  * MS-TCT windows: a random contiguous 256-frame window per video
    (Temporal_mstct/dataloader.py:224-245).

The port's copy of ``data/temporal.py`` in the JAX package. There, XLA
compiles one program per shape, so sequences are padded to power-of-two
buckets with a ``frame_mask`` (``pick_bucket``, ``pad_sequence_batch``).
The port's MS-TCT driver does not pad: eager PyTorch has no per-shape
compile to save, and MS-TCT attends over every frame it is given with no
key mask, so padding would change the real frames' outputs. The bucket
helpers are kept for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .feature_store import FeatureStore, video_key
from .labels import load_video_labels

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


def black_frame_dedup(feats: np.ndarray) -> np.ndarray:
    """Row indices to KEEP after dropping frozen/black consecutive pairs."""
    delta = feats[1:, :] - feats[:-1, :]
    idx1 = np.where(np.sum(delta, axis=-1) == 0)[0]
    drop = np.unique(np.concatenate([idx1, idx1 + 1])) if len(idx1) else \
        np.array([], dtype=np.int64)
    keep = np.setdiff1d(np.arange(len(feats)), drop)
    return keep


@dataclass
class TemporalSequence:
    video: str
    features: np.ndarray  # (T, D)
    labels: Dict[str, np.ndarray]  # task -> (T, C)
    kept_mask: Optional[np.ndarray] = None  # original-length 0/1 after dedup

    @property
    def length(self) -> int:
        return self.features.shape[0]


class TemporalSequenceDataset:
    """Per-video (features, labels) sequences from the cached-feature bus."""

    def __init__(self, dataset_dir: str, store: FeatureStore, fold: int,
                 videos: Sequence[str], task: str = "",
                 dedup_black: bool = False):
        feats = store.load(fold, "feats", task=task)
        self._seqs: Dict[str, TemporalSequence] = {}
        for v in videos:
            f = np.asarray(feats[video_key(v)], np.float32)
            lab = load_video_labels(dataset_dir, v)
            n = min(len(f), len(lab))
            f = f[:n]
            labels = {"i": lab.tool[:n], "v": lab.verb[:n],
                      "t": lab.target[:n], "ivt": lab.triplet[:n]}
            kept_mask = None
            if dedup_black:
                keep = black_frame_dedup(f)
                kept_mask = np.zeros(n, np.int8)
                kept_mask[keep] = 1
                f = f[keep]
                labels = {k: a[keep] for k, a in labels.items()}
            self._seqs[v] = TemporalSequence(v, f, labels, kept_mask)

    def __getitem__(self, video: str) -> TemporalSequence:
        return self._seqs[video]

    def videos(self) -> List[str]:
        return list(self._seqs)


def sample_clip(rng: np.random.Generator, seq: TemporalSequence,
                full_prob: float = 0.3, min_len: int = 10,
                max_len: int = 1000) -> TemporalSequence:
    """Reference clip sampling: full video w.p. ``full_prob`` else random clip."""
    t = seq.length
    if rng.random() < full_prob or t <= min_len:
        return seq
    hi = min(max_len, t)
    n = int(rng.integers(min_len, hi)) if hi > min_len else t
    if t - n <= 0:
        return seq
    start = int(rng.integers(0, t - n))
    return TemporalSequence(
        seq.video, seq.features[start:start + n],
        {k: a[start:start + n] for k, a in seq.labels.items()})


def sample_window(rng: np.random.Generator, seq: TemporalSequence,
                  window: int = 256) -> TemporalSequence:
    """MS-TCT random contiguous window (pad-short videos keep full length)."""
    t = seq.length
    if t <= window:
        return seq
    start = int(rng.integers(0, t - window))
    return TemporalSequence(
        seq.video, seq.features[start:start + window],
        {k: a[start:start + window] for k, a in seq.labels.items()})


def pick_bucket(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    # beyond the precomputed list: next power of two (never truncate — a
    # truncated video would silently mis-score against full-length labels)
    b = buckets[-1]
    while b < length:
        b *= 2
    return b


def pad_sequence_batch(seq: TemporalSequence,
                       buckets: Sequence[int] = DEFAULT_BUCKETS
                       ) -> Dict[str, np.ndarray]:
    """Pad one sequence to its bucket; returns a jit-ready batch dict."""
    b = pick_bucket(seq.length, buckets)
    t = min(seq.length, b)
    pad = b - t
    feats = np.pad(seq.features[:t], ((0, pad), (0, 0)))
    batch = {"features": feats[None],
             "frame_mask": (np.arange(b) < t).astype(np.float32)}
    for k, a in seq.labels.items():
        batch[f"label_{k}"] = np.pad(a[:t].astype(np.float32),
                                     ((0, pad), (0, 0)))
    batch["length"] = np.asarray(t)
    return batch
