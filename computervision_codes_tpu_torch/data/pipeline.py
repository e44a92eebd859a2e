"""Host input pipeline: dataset index + threaded, double-buffered batch feed.

The port's copy of ``data/pipeline.py`` in the JAX package, which replaces
the reference's torch DataLoader worker processes
(MT4MTLKD/Spatial_cnn/run.py:367-381): a flat frame index over (video, row)
pairs, per-item decode+augment on a producer thread, and a bounded queue so
the next batch is being decoded while the device computes (double
buffering); ``data.prefetch.prefetch_to_device`` overlaps the copy to the
card.

Frames come from the port's data plane (``data.native``), its only
decoder: evaluation decodes each chunk of frames in one threaded call, and
training decodes each frame at ``image_size`` (the first step of
``train_transform``) before its augmentations (``data.transforms``).

The frame index also carries the cached-teacher lookups of the KD student
loader (Spatial_cnn/dataloader.py:216-238: 3 pred pickles + 3 feat pickles,
rows aligned with label rows).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import native
from . import transforms as T
from .feature_store import FeatureStore, video_key
from .labels import VideoLabels, load_video_labels
from .splits import Split, resolve_split


@dataclass
class VideoData:
    """One video's labels plus optional aligned teacher arrays."""

    labels: VideoLabels
    teacher: Dict[str, np.ndarray] = field(default_factory=dict)


class CholecDataset:
    """Split-resolved dataset index (reference CholecT50 class equivalent,
    Spatial_cnn/dataloader.py:45-201)."""

    def __init__(self, dataset_dir: str, variant: str = "cholect45-crossval",
                 test_fold: int = 1,
                 augmentation_list: Sequence[str] = T.DEFAULT_AUGS,
                 image_size: Tuple[int, int] = T.DEFAULT_SIZE,
                 device_augment: bool = False):
        self.dataset_dir = dataset_dir
        self.split: Split = resolve_split(variant, test_fold)
        self.augmentation_list = tuple(augmentation_list)
        self.image_size = tuple(image_size)
        # device_augment: TRAIN frames leave the host as resized uint8, to
        # be augmented and normalised on the device
        self.device_augment = device_augment
        self._videos: Dict[str, VideoData] = {}

    def video(self, name: str) -> VideoData:
        if name not in self._videos:
            self._videos[name] = VideoData(
                labels=load_video_labels(self.dataset_dir, name))
        return self._videos[name]

    def container(self, name: str) -> None:
        """None for the stills layout (``<root>/data/VIDxx/`` PNG files).
        A video shipped as an MJPEG container (``<root>/data/VIDxx.avi`` or
        ``.mjpg``, MT4MTLKD/readme.md:30-89) opens a ``VideoReader``, which
        raises: the data plane decodes PNG only (no libjpeg)."""
        for ext in (".avi", ".mjpg"):
            p = os.path.join(self.dataset_dir, "data", name + ext)
            if os.path.exists(p):
                native.VideoReader(p)
        return None

    def attach_teachers(self, store: FeatureStore, pred_store: FeatureStore,
                        fold: int, videos: Sequence[str]) -> None:
        """Load the 6 teacher artifacts for the KD student train split."""
        preds = {k: pred_store.load(fold, "pred", task=k) for k in ("i", "v", "t")}
        feats = {k: store.load(fold, "feats", task=k) for k in ("i", "v", "t")}
        for v in videos:
            vd = self.video(v)
            key = video_key(v)
            for k in ("i", "v", "t"):
                vd.teacher[f"pred_{k}"] = preds[k][key]
                vd.teacher[f"feat_{k}"] = feats[k][key]

    def frame_index(self, videos: Sequence[str]) -> List[Tuple[str, int]]:
        out = []
        for v in videos:
            out.extend((v, i) for i in range(len(self.video(v).labels)))
        return out

    def _decode_u8(self, video: str, row: int) -> np.ndarray:
        """Frame ``row`` of ``video`` at ``image_size``, (H, W, 3) uint8."""
        self.container(video)
        img = np.empty(self.image_size + (3,), np.uint8)
        native.decode_one_u8(
            self.video(video).labels.frame_path(self.dataset_dir, row), img)
        return img

    def load_frame(self, video: str, row: int,
                   rng: Optional[np.random.Generator] = None,
                   teacher_dim: int = 1536,
                   two_views: bool = False,
                   decode: bool = True) -> Dict[str, np.ndarray]:
        vd = self.video(video)
        lab = vd.labels
        item: Dict[str, np.ndarray] = {}
        if decode:
            img = self._decode_u8(video, row)
            if rng is not None:
                if self.device_augment:
                    # both views derive on the device from ONE uint8 upload
                    arr = T.raw_resize_u8(img, self.image_size)
                else:
                    arr = T.train_transform(rng, img, self.image_size,
                                            self.augmentation_list)
            else:
                arr = T.eval_transform(img, self.image_size)
            item["image"] = arr
        if two_views and decode and self.device_augment and rng is not None:
            pass  # device path: views are generated on the device from "image"
        elif two_views and decode:
            # TERL two-crop protocol (TERL/6_baseline_learnT/dataloader.py:
            # 101,233-266): two independent augmentations of the same frame
            item["image2"] = (
                T.train_transform(rng, img, self.image_size,
                                  self.augmentation_list)
                if rng is not None else arr)
        item.update({
            "label_i": lab.tool[row],
            "label_v": lab.verb[row],
            "label_t": lab.target[row],
            "label_ivt": lab.triplet[row],
        })
        t = vd.teacher
        for k in ("i", "v", "t"):
            item[f"teacher_pred_{k}"] = t.get(
                f"pred_{k}", np.zeros((len(lab), {"i": 6, "v": 10, "t": 15}[k]),
                                      np.float32))[row]
            item[f"teacher_feat_{k}"] = t.get(
                f"feat_{k}", np.zeros((len(lab), teacher_dim), np.float32))[row]
        return item


def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _decode_chunk(dataset: CholecDataset,
                  chunk: List[Tuple[str, int]]) -> np.ndarray:
    """The chunk's frames, normalised, in one threaded native decode per
    video."""
    h, w = dataset.image_size
    imgs = np.empty((len(chunk), h, w, 3), np.float32)
    by_vid: Dict[str, list] = {}
    for pos, (v, i) in enumerate(chunk):
        by_vid.setdefault(v, []).append((pos, i))
    for v, lst in by_vid.items():
        dataset.container(v)
        paths = [dataset.video(v).labels.frame_path(dataset.dataset_dir, i)
                 for _, i in lst]
        arr = native.decode_batch(paths, dataset.image_size)
        for (pos, _), a in zip(lst, arr):
            imgs[pos] = a
    return imgs


def batch_iterator(dataset: CholecDataset, videos: Sequence[str],
                   batch_size: int, train: bool, seed: int = 0,
                   teacher_dim: int = 1536, drop_last: bool = False,
                   pad_last: bool = False, two_views: bool = False,
                   prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Threaded prefetching batch stream over the given videos.

    ``pad_last``: repeat-pad the final short batch to ``batch_size`` and add
    a ``valid`` mask — keeps shapes static for the fixed-shape sessions
    (eval loops slice by the mask on host). NOTE for training: the
    reference trains the final short batch at its natural size; here the
    repeated pad frames contribute to the final batch's loss — at reference
    batch sizes this is <0.1% of samples per epoch.
    """
    index = dataset.frame_index(videos)
    rng = np.random.default_rng(seed)
    if train:
        rng.shuffle(index)

    def producer(q: queue.Queue):
        # exceptions are forwarded to the consumer (a silently dying worker
        # would truncate the stream and corrupt per-video metrics)
        try:
            for start in range(0, len(index), batch_size):
                chunk = index[start:start + batch_size]
                if drop_last and len(chunk) < batch_size:
                    break
                items = [
                    dataset.load_frame(v, i,
                                       rng=rng if train else None,
                                       teacher_dim=teacher_dim,
                                       two_views=two_views,
                                       decode=train)
                    for v, i in chunk
                ]
                batch = _collate(items)
                if not train:
                    batch["image"] = _decode_chunk(dataset, chunk)
                n = len(chunk)
                if pad_last and n < batch_size:
                    pad = batch_size - n
                    batch = {k: np.concatenate(
                        [a, np.repeat(a[-1:], pad, axis=0)]) for k, a in
                        batch.items()}
                batch["valid"] = np.arange(
                    batch["image"].shape[0]) < n
                q.put(batch)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(e)
        finally:
            q.put(None)

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    thread = threading.Thread(target=producer, args=(q,), daemon=True)
    thread.start()
    while True:
        batch = q.get()
        if batch is None:
            break
        if isinstance(batch, BaseException):
            raise batch
        yield batch


def video_eval_batches(dataset: CholecDataset, video: str, batch_size: int,
                       pad_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Per-video evaluation stream (the reference evaluates video by video)."""
    yield from batch_iterator(dataset, [video], batch_size, train=False,
                              pad_last=pad_last)
