"""Score a surgical video -> per-frame triplet probabilities, on the card.

The port's copy of ``cli/infer.py`` in the JAX package, the production
inference entry point the reference lacks (its eval paths only dump
pickles from inside train/test loops, MT4MTLKD/Spatial_cnn/test.py:
248-286). One command takes a video, a reference-layout PNG frame
directory, and weights (a checkpoint that the JAX package's
``CheckpointManager`` wrote, or ``--random_init``), and writes per-frame
probabilities for all four tasks.

Usage:
  python -m computervision_codes_tpu_torch.cli.infer \\
      --video /data/VID01 \\
      --ckpt_dir __checkpoint__/run_Res18 --modelname <name> [--quantize] \\
      --out preds.npz [--device cuda]

The offline path windows the video into (batch, clip_len) clips through
``InferenceSession`` (uint8 in, normalised on the device) and trims the
tail padding; ``--streaming`` instead drives the per-frame
``StreamingSession`` (causal ring buffer) for latency-realistic output.

Host memory stays bounded at two decode spans regardless of video length
(a 2 h surgery is ~180k frames ≈ 62 GB of uint8 at the serving geometry —
never materialized): frames are decoded span by span by the data plane's
threads (``data.native.decode_batch_u8``), with the next span decoding on a
worker thread while the device scores the current one; the decode releases
the GIL in its file reads, its inflate and its C calls. Output: .npz with
float32 arrays i/v/t/ivt of shape (T, C).

``--servable`` serves an exported session (``cli.export`` or a session's
``export``; a JAX-written servable too), offline or with ``--streaming``,
its shape and TCN taken from the servable and the frames decoded at its
height and width. Not ported: MJPEG containers (``.avi``/``.mjpg``: the
data plane has no libjpeg, so they raise).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from ..data import native

TASKS = ("ivt", "i", "v", "t")


class _FrameSource:
    """Random-access uint8 frames at the serving geometry, decoded on
    demand so that only the spans in flight are held."""

    def __init__(self, video: str, size):
        self._size = size
        if video.endswith((".avi", ".mjpg")):
            native.VideoReader(video)  # raises: no libjpeg
        if not os.path.isdir(video):
            raise ValueError(f"--video must be an .avi/.mjpg container or "
                             f"a frame directory, got {video!r}")
        self._names = [os.path.join(video, f)
                       for f in sorted(os.listdir(video))
                       if f.endswith((".png", ".jpg"))]
        if not self._names:
            raise ValueError(f"no frames in {video}")

    def __len__(self) -> int:
        return len(self._names)

    def read(self, start: int, count: int) -> np.ndarray:
        """(min(count, T-start), H, W, 3) uint8 — clamped at the tail."""
        return native.decode_batch_u8(self._names[start:start + count],
                                      self._size)


def _session(cls, flags, kw: dict):
    if flags.servable:
        return cls.load_exported(flags.servable, device=flags.device)
    if flags.ckpt_dir:
        return cls.from_checkpoint(flags.ckpt_dir, flags.modelname, **kw)
    if flags.random_init:
        return cls.create(**kw)
    raise ValueError("need --servable, --ckpt_dir or --random_init")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video", type=str, required=True,
                   help="a PNG frame directory (.avi/.mjpg containers need "
                        "libjpeg and raise)")
    p.add_argument("--servable", type=str, default="",
                   help="an exported servable (cli.export / sess.export())")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--modelname", type=str, default="")
    p.add_argument("--network", type=str, default="resnet18")
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--random_init", action="store_true",
                   help="no weights (plumbing checks only)")
    p.add_argument("--streaming", action="store_true",
                   help="per-frame causal StreamingSession instead of "
                        "offline clip batching")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--clip_len", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=448)
    # streaming-session TCN geometry (offline sessions serve the default
    # TCN); reference flag names, temporal_tcn.py:55-58
    p.add_argument("--context", type=int, default=256)
    p.add_argument("--num_layers_PG", type=int, default=11)
    p.add_argument("--num_layers_R", type=int, default=10)
    p.add_argument("--num_R", type=int, default=3)
    p.add_argument("--num_f_maps", type=int, default=512)
    p.add_argument("--out", type=str, default="",
                   help="write .npz of per-frame probabilities here")
    p.add_argument("--device", type=str, default="cuda",
                   help="the sessions' device (cpu only when asked)")
    flags, _ = p.parse_known_args(argv)

    from .. import serving

    if flags.servable:  # the servable's geometry decides the decode size
        with open(os.path.join(flags.servable, "meta.json")) as fh:
            meta = json.load(fh)
        flags.height, flags.width = meta["height"], meta["width"]
    src = _FrameSource(flags.video, (flags.height, flags.width))
    t = len(src)

    common = dict(height=flags.height, width=flags.width,
                  network=flags.network, quantize=flags.quantize,
                  device=flags.device)
    if flags.streaming:
        sess = _session(serving.StreamingSession, flags, dict(
            common, streams=1, context=flags.context,
            num_layers_pg=flags.num_layers_PG,
            num_layers_r=flags.num_layers_R, num_refinements=flags.num_R,
            num_f_maps=flags.num_f_maps))
        span = max(flags.batch * flags.clip_len, 256)
        score = lambda chunk: _score_streaming(sess, chunk)  # noqa: E731
    else:
        sess = _session(serving.InferenceSession, flags,
                        dict(common, batch=flags.batch,
                             clip_len=flags.clip_len))
        b, cl = sess.batch, sess.clip_len
        span = b * cl
        score = lambda chunk: _score_offline(sess, b, cl, chunk)  # noqa: E731
    t0 = time.perf_counter()
    probs = _drive(src, t, span, score)
    seconds = time.perf_counter() - t0

    result = {"frames": t, "probs": probs, "seconds": seconds}
    top = np.argmax(probs["ivt"], axis=1)
    print(f"scored {t} frames in {seconds:.3f} s ({t / seconds:.1f} "
          f"frames/s, decode overlapped, host clock) | modal top-1 triplet "
          f"class {int(np.bincount(top).argmax())} | mean max-prob "
          f"{float(probs['ivt'].max(axis=1).mean()):.4f}")
    if flags.out:
        np.savez(flags.out, **{k: probs[k].astype(np.float32)
                               for k in probs})
        print(f"wrote {flags.out}")
        result["out"] = flags.out
    return result


def _score_offline(sess, batch: int, clip_len: int,
                   chunk: np.ndarray) -> dict:
    """One span (<= batch*clip_len frames) -> per-frame probs, tail
    zero-padded to the session's shape and trimmed back."""
    n, span = chunk.shape[0], batch * clip_len
    if n < span:
        chunk = np.concatenate(
            [chunk, np.zeros((span - n,) + chunk.shape[1:], np.uint8)])
    out = sess.predict(chunk.reshape(batch, clip_len, *chunk.shape[1:]))
    return {k: np.asarray(out[k]).reshape(span, -1)[:n] for k in TASKS}


def _score_streaming(sess, chunk: np.ndarray) -> dict:
    outs = [sess.push(frame) for frame in chunk]
    return {k: np.stack([o[k] for o in outs]) for k in TASKS}


def _drive(src: _FrameSource, t: int, span: int, score) -> dict:
    """Decode span i+1 on a worker thread while the device scores span i;
    at most two spans of uint8 are resident at any time."""
    from concurrent.futures import ThreadPoolExecutor

    parts = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(src.read, 0, span)
        for start in range(0, t, span):
            chunk = nxt.result()
            if start + span < t:
                nxt = pool.submit(src.read, start + span, span)
            parts.append(score(chunk))
    return {k: np.concatenate([p[k] for p in parts]) for k in TASKS}


if __name__ == "__main__":
    main(sys.argv[1:])
