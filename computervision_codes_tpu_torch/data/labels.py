"""Per-video CSV label parsing for CholecT45/50.

The port's copy of ``data/labels.py`` in the JAX package.

Layout (reference: MT4MTLKD/readme.md:30-89, parsing at
MT4MTLKD/Spatial_cnn/dataloader.py:209-212,251-257):

  <root>/data/VIDxx/<frame>.png        frames at 1 fps
  <root>/triplet/VIDxx.txt             rows: frame_id, 100 one-hot cols
  <root>/instrument/VIDxx.txt          rows: frame_id, 6 one-hot cols
  <root>/verb/VIDxx.txt                rows: frame_id, 10 one-hot cols
  <root>/target/VIDxx.txt              rows: frame_id, 15 one-hot cols

The first CSV column is the frame id; the PNG basename is that id
zero-padded to 6 digits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

TASK_DIRS = {"triplet": "triplet", "i": "instrument", "v": "verb", "t": "target"}
TASK_WIDTHS = {"triplet": 100, "i": 6, "v": 10, "t": 15}


@dataclass(frozen=True)
class VideoLabels:
    """All labels for one video, rows aligned across tasks by frame."""

    video: str
    frame_ids: np.ndarray  # (N,) int
    triplet: np.ndarray    # (N, 100) float32
    tool: np.ndarray       # (N, 6) float32
    verb: np.ndarray       # (N, 10) float32
    target: np.ndarray     # (N, 15) float32

    def __len__(self) -> int:
        return len(self.frame_ids)

    def frame_basename(self, index: int) -> str:
        return "{}.png".format(str(int(self.frame_ids[index])).zfill(6))

    def frame_path(self, dataset_dir: str, index: int) -> str:
        return os.path.join(dataset_dir, "data", self.video, self.frame_basename(index))


def _load_task(dataset_dir: str, video: str, task: str) -> np.ndarray:
    path = os.path.join(dataset_dir, TASK_DIRS[task], f"{video}.txt")
    arr = np.loadtxt(path, dtype=np.int64, delimiter=",")
    if arr.ndim == 1:  # single-frame video
        arr = arr[None, :]
    want = TASK_WIDTHS[task] + 1
    if arr.shape[1] != want:
        raise ValueError(f"{path}: expected {want} columns, got {arr.shape[1]}")
    return arr


def load_video_labels(dataset_dir: str, video: str) -> VideoLabels:
    triplet = _load_task(dataset_dir, video, "triplet")
    tool = _load_task(dataset_dir, video, "i")
    verb = _load_task(dataset_dir, video, "v")
    target = _load_task(dataset_dir, video, "t")
    return VideoLabels(
        video=video,
        frame_ids=triplet[:, 0],
        triplet=triplet[:, 1:].astype(np.float32),
        tool=tool[:, 1:].astype(np.float32),
        verb=verb[:, 1:].astype(np.float32),
        target=target[:, 1:].astype(np.float32),
    )
