"""Class-activation-map overlays (TERL's cam.py).

Counterpart of ``computervision_codes_tpu/utils/cam.py`` (the reference's
TERL/6_baseline_learnT/cam.py:200-278: a CAM drawn in JET over the frame).
The CAMs are model outputs (``models.moco.MoCoEncoder`` returns one map a
task), so this module only renders. The JAX module calls cv2, which the
card's machine does not have; here numpy does cv2's two steps:

- ``resize_linear_u8``: cv2's ``resize`` with ``INTER_LINEAR`` on uint8, in
  its fixed point (11-bit coefficients of the half-pixel source positions,
  a border sample repeated, the vertical sum rounded as its vector path
  rounds it); builds that hand the call to IPP round a few values the
  other way (within 1 LSB);
- ``JET``: cv2's ``COLORMAP_JET`` table (RGB), the piecewise-linear ramps
  in steps of 4 / 255 from which cv2 builds it, rounded to uint8.

The overlay is written with the port's own PNG writer
(``data.synthetic.write_png``).
"""

from __future__ import annotations

import numpy as np

from ..data.synthetic import write_png
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
COEF_ONE = 1 << COEF_BITS


def _jet() -> np.ndarray:
    """(256, 3) uint8 RGB: each channel 255 on its plateau, ramps of 4 / 255
    a step on either side (red's rise and blue's fall half a step later
    than green's, as cv2's table has them)."""
    i = np.arange(256, dtype=np.float64)
    r = np.where(i < 96, 0.0, np.where(i < 160, 1.5 + 4 * (i - 96),
                                       np.where(i < 224, 255.0,
                                                252 - 4 * (i - 224))))
    g = np.where(i < 33, 0.0, np.where(i < 96, 4 * (i - 32),
                                       np.where(i < 160, 255.0,
                                                252 - 4 * (i - 160))))
    b = np.where(i < 32, 127.5 + 4 * i, np.where(i < 96, 255.0,
                                                  254.5 - 4 * (i - 96)))
    lut = np.stack([r, g, b], axis=-1)
    return np.clip(np.rint(lut), 0, 255).astype(np.uint8)


JET = _jet()


def _coeffs(src: int, dst: int):
    """Per output sample along one axis: the two source indices and their
    11-bit weights, from the half-pixel position (float32, as cv2)."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s0 = np.floor(pos).astype(np.int64)
    frac = (pos - s0).astype(np.float32)
    low, high = s0 < 0, s0 >= src - 1
    frac[low | high] = 0.0
    s0 = np.clip(s0, 0, src - 1)
    w1 = np.rint(frac * np.float32(COEF_ONE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(COEF_ONE)).astype(
        np.int64)
    return s0, np.minimum(s0 + 1, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height)) of a (h, w) uint8 map, bilinear."""
    h, w = img.shape
    x0, x1, a0, a1 = _coeffs(w, width)
    y0, y1, b0, b1 = _coeffs(h, height)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1  # (h, width), 11-bit scaled
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    v = (((b0[:, None] * s0) >> 16) + ((b1[:, None] * s1) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def normalize_cam(cam: np.ndarray) -> np.ndarray:
    """Min-max normalise a (h, w) activation map to [0, 1]."""
    cam = np.asarray(cam, np.float32)
    lo, hi = float(cam.min()), float(cam.max())
    if hi - lo < 1e-12:
        return np.zeros_like(cam)
    return (cam - lo) / (hi - lo)


def render_cam_overlay(image: np.ndarray, cam: np.ndarray,
                       alpha: float = 0.4) -> np.ndarray:
    """Blend a JET-coloured CAM over an RGB uint8 image (H, W, 3)."""
    h, w = image.shape[:2]
    heat = resize_linear_u8(np.uint8(255 * normalize_cam(cam)), w, h)
    return (alpha * JET[heat] + (1 - alpha) * image).astype(np.uint8)


def draw_cam(image: np.ndarray, cam: np.ndarray, path: str,
             alpha: float = 0.4) -> str:
    """Render and save a CAM overlay PNG (reference draw_CAM, cam.py:221)."""
    return write_png(path, render_cam_overlay(image, cam, alpha))


def denormalize_frame(image: np.ndarray) -> np.ndarray:
    """ImageNet-normalised (H, W, 3) float -> displayable uint8 RGB (the
    reference re-reads the PNG for the overlay's base, cam.py:272; undoing
    the normalisation gives the same image without a second decode)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    img = (np.asarray(image, np.float32) * std + mean) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)
