"""Synthetic CholecT45-layout trees for the tests and the card's smoke run.

The port's copy of ``data/synthetic.py`` in the JAX package:
``synthetic_frame``, ``synthetic_labels``, ``write_synthetic_dataset``
(label CSVs, and with ``write_images`` PNG frames), ``write_png``,
``write_mjpeg_avi`` and ``synthetic_feature_dict``. Labels are
bank-consistent, and the pixels come from the same generator draws as in
the JAX package, so both write the same labels and frames. PNG files are
written with the standard library only (``zlib``); MJPEG containers need a
JPEG encoder, and the port's data plane is built without libjpeg, so
``write_mjpeg_avi`` (and ``container=True``) raises naming it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

from .bank import NUM_TARGET, NUM_TOOL, NUM_TRIPLET, NUM_VERB, load_bank
from .native import NO_LIBJPEG, PNG_SIGNATURE


def synthetic_frame(rng: np.random.Generator, height: int,
                    width: int) -> np.ndarray:
    """A small random RGB uint8 frame."""
    return rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)


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
    height: int = 64,
    width: int = 112,
    seed: int = 0,
    frame_stride: int = 25,
    write_images: bool = False,
    container: bool = False,
) -> str:
    """Write a synthetic tree at ``root`` and return it: the label CSVs,
    and with ``write_images`` the frames, as PNG files
    ``<root>/data/VIDxx/<id>.png`` (``container=True``: one MJPEG AVI per
    video, which raises, see the module's note).

    The labels and then the pixels of video ``vi`` come from
    ``default_rng(seed + 1000 + vi)``, as in the JAX package, so at one
    frame count both write the same files and pixels.
    ``frames_per_video`` may also give one count per video.
    """
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
        img_dir = os.path.join(root, "data", video)
        if write_images and container:
            os.makedirs(os.path.join(root, "data"), exist_ok=True)
            frames = np.stack([synthetic_frame(vid_rng, height, width)
                               for _ in frame_ids])
            write_mjpeg_avi(img_dir + ".avi", frames)
        elif write_images:
            os.makedirs(img_dir, exist_ok=True)
            for fid in frame_ids:
                write_png(os.path.join(img_dir, f"{int(fid):06d}.png"),
                          synthetic_frame(vid_rng, height, width))
        for task, subdir in (("triplet", "triplet"), ("tool", "instrument"),
                             ("verb", "verb"), ("target", "target")):
            rows = np.concatenate([frame_ids[:, None], labels[task]], axis=1)
            np.savetxt(os.path.join(root, subdir, f"{video}.txt"), rows,
                       fmt="%d", delimiter=",")
    return root


def _png_filter(rgb: np.ndarray, filter_type: Optional[int]) -> np.ndarray:
    """(h, w, 3) uint8 -> (h, 1 + 3w) rows of a PNG's image data. Every
    row is filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), or with ``None`` each row with its own, as PIL's encoder
    chooses: of None, Sub, Up and Paeth (PIL tries no Average), the one
    whose bytes, read as signed, have the least sum of absolute values,
    ties to the lower type (libpng's heuristic)."""
    if filter_type not in (None, 0, 1, 2, 3, 4):
        raise ValueError(f"PNG filter type {filter_type} (0-4 or None)")
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)  # left
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)  # above
    b[1:] = x[:-1]
    c = np.zeros_like(x)  # above left
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (0, a, b, (a + b) >> 1, paeth)
    types = (0, 1, 2, 4) if filter_type is None else (filter_type,)
    res = np.stack([(x - preds[t]) & 0xFF for t in types])  # (types, h, 3w)
    pick = np.minimum(res, 256 - res).sum(-1).argmin(0)
    rows = np.empty((h, 1 + w * 3), np.uint8)
    rows[:, 0] = np.asarray(types)[pick]
    rows[:, 1:] = res[pick, np.arange(h)]
    return rows


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, rgb: np.ndarray, level: int = 6,
              filter_type: Optional[int] = None) -> str:
    """Write (h, w, 3) uint8 as an 8-bit RGB PNG: the rows filtered as
    ``_png_filter`` says (by default each row's own, as PIL writes),
    deflated at ``level``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    idat = zlib.compress(_png_filter(rgb, filter_type).tobytes(), level)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))
    return path


def write_mjpeg_avi(path: str, frames: np.ndarray, fps: int = 25,
                    quality: int = 90) -> str:
    """Mux (N, H, W, 3) uint8 frames into an MJPEG-in-AVI file: the JAX
    package's writer encodes each frame as a JPEG, which needs libjpeg, and
    the port's data plane is built without it, so this raises."""
    raise RuntimeError(NO_LIBJPEG.format(path))


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
