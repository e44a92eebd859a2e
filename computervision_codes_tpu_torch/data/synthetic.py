"""Synthetic CholecT45-layout trees for the tests and the card's smoke run.

The port's copy of the CSV side of ``data/synthetic.py`` in the JAX package:
``synthetic_labels``, ``write_synthetic_dataset`` (label files only) and
``synthetic_feature_dict``. Labels are bank-consistent, as there. The GPU
machine has no PIL, so ``write_synthetic_dataset(write_images=True)``
raises instead of writing PNG frames; the temporal stages read cached
features and never the frames.
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np

from .bank import NUM_TARGET, NUM_TOOL, NUM_TRIPLET, NUM_VERB, load_bank


def synthetic_labels(rng: np.random.Generator, num_frames: int,
                     max_triplets_per_frame: int = 2) -> dict:
    """Random per-frame multi-hot triplet labels + bank-consistent components."""
    bank = load_bank()
    triplet = np.zeros((num_frames, NUM_TRIPLET), dtype=np.int64)
    tool = np.zeros((num_frames, NUM_TOOL), dtype=np.int64)
    verb = np.zeros((num_frames, NUM_VERB), dtype=np.int64)
    target = np.zeros((num_frames, NUM_TARGET), dtype=np.int64)
    for f in range(num_frames):
        k = int(rng.integers(0, max_triplets_per_frame + 1))
        for t in rng.choice(NUM_TRIPLET, size=k, replace=False):
            triplet[f, t] = 1
            tool[f, bank[t, 1]] = 1
            verb[f, bank[t, 2]] = 1
            target[f, bank[t, 3]] = 1
    return {"triplet": triplet, "tool": tool, "verb": verb, "target": target}


def write_synthetic_dataset(
    root: str,
    videos: Sequence[str],
    frames_per_video: Union[int, Sequence[int]] = 6,
    seed: int = 0,
    frame_stride: int = 25,
    write_images: bool = False,
) -> str:
    """Write the label CSVs of a synthetic tree at ``root`` and return it.

    The labels of video ``vi`` come from ``default_rng(seed + 1000 + vi)``,
    as in the JAX package, so at one frame count both write the same files.
    ``frames_per_video`` may also give one count per video.
    """
    if write_images:
        raise RuntimeError("write_synthetic_dataset(write_images=True) needs "
                           "PIL, which the port does not use; write the "
                           "frames with the JAX package's data.synthetic")
    counts = ([frames_per_video] * len(videos)
              if isinstance(frames_per_video, int) else list(frames_per_video))
    if len(counts) != len(videos):
        raise ValueError(f"{len(counts)} frame counts for {len(videos)} "
                         f"videos")
    for task_dir in ("triplet", "instrument", "verb", "target"):
        os.makedirs(os.path.join(root, task_dir), exist_ok=True)
    for vi, (video, n) in enumerate(zip(videos, counts)):
        vid_rng = np.random.default_rng(seed + 1000 + vi)
        labels = synthetic_labels(vid_rng, n)
        frame_ids = np.arange(n) * frame_stride
        for task, subdir in (("triplet", "triplet"), ("tool", "instrument"),
                             ("verb", "verb"), ("target", "target")):
            rows = np.concatenate([frame_ids[:, None], labels[task]], axis=1)
            np.savetxt(os.path.join(root, subdir, f"{video}.txt"), rows,
                       fmt="%d", delimiter=",")
    return root


def synthetic_feature_dict(videos: Sequence[str],
                           num_frames: Union[int, Sequence[int]], dim: int,
                           seed: int = 0) -> dict:
    """Random cached-feature dict in the feature-bus format (keyed by video);
    ``num_frames`` may give one count per video."""
    rng = np.random.default_rng(seed)
    counts = ([num_frames] * len(videos) if isinstance(num_frames, int)
              else list(num_frames))
    return {v: rng.standard_normal((n, dim)).astype(np.float32)
            for v, n in zip(videos, counts)}
