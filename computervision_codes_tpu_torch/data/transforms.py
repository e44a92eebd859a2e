"""Host-side image transforms on (H, W, 3) uint8 numpy arrays, without PIL.

The port's copy of ``data/transforms.py`` in the JAX package (reference
pipeline: MT4MTLKD/Spatial_cnn/dataloader.py:89-97,153-162):
Resize(256,448) -> [augs] -> Resize(256,448) -> ToTensor -> ImageNet norm.
Augs and probabilities as there: vflip p=0.4, hflip p=0.4, 'contrast' (the
reference's dict overwrites ColorJitter with RandomAutocontrast(p=0.5)
under that key, dataloader.py:93,96), rot90 = uniform(-90,90) rotation with
expansion; 'jitter' and 'brightness' (Sharpness 1.6) as opt-ins.

Each augmentation makes the same ``rng`` calls in the same order as the
JAX package's, so one seed makes the same choices in both, and computes
what PIL computes there:

* flips and autocontrast (``ImageOps.autocontrast``, cutoff 0) exactly;
* ``rot90`` as ``Image.rotate(angle, expand=True)``: PIL's expanded size,
  its 16.16 fixed-point inverse map with NEAREST sampling, black outside;
* ``jitter`` and ``brightness`` as ``ImageEnhance`` (Brightness, Contrast,
  Sharpness): ``Image.blend`` in float32 of the image with its degenerate
  (black, the mean gray, the SMOOTH filter's output);
* the resizes through the native plane's fixed-point bilinear
  (``data.native.resize_u8``), within 1 LSB of PIL's.

Output is float32 NHWC, ImageNet-normalised.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

DEFAULT_SIZE = (256, 448)  # (H, W)
DEFAULT_AUGS = ("original", "vflip", "hflip", "contrast", "rot90")


def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    if img.shape[:2] == tuple(size):
        return img  # PIL returns a copy: the same pixels
    from .native import resize_u8

    return resize_u8(img, size)


def _autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast`` at cutoff 0: per channel, the lookup table
    that maps its darkest value to 0 and its lightest to 255."""
    out = np.empty_like(img)
    ix = np.arange(256)
    for ch in range(3):
        band = img[..., ch]
        lo, hi = int(band.min()), int(band.max())
        if hi <= lo:
            lut = ix
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            lut = np.clip((ix * scale + offset).astype(np.int64), 0, 255)
        out[..., ch] = lut.astype(np.uint8)[band]
    return out


def _blend(degenerate: np.ndarray, img: np.ndarray,
           factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)``: in1 + alpha (in2 - in1) in
    float32, truncated, clipped to [0, 255] when extrapolating."""
    alpha = np.float32(factor)
    in1 = degenerate.astype(np.float32)
    out = in1 + alpha * (img.astype(np.float32) - in1)
    if not 0.0 <= factor <= 1.0:
        out = np.clip(out, 0.0, 255.0)
    return out.astype(np.uint8)


def _gray_mean(img: np.ndarray) -> int:
    """The rounded mean of PIL's "L" conversion (ITU-R 601-2 luma in 16.16
    fixed point)."""
    rgb = img.astype(np.int64)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return int(luma.mean() + 0.5)


def _smooth(img: np.ndarray) -> np.ndarray:
    """``ImageFilter.SMOOTH``: the 3x3 kernel (1 1 1 / 1 5 1 / 1 1 1) / 13
    in float32, summed as PIL sums it (0.5, then the row below, the row,
    the row above, each left to right), truncated; the border kept."""
    x = img.astype(np.float32)
    k = np.float32(1.0) / np.float32(13.0)
    k5 = np.float32(5.0) / np.float32(13.0)
    h, w = x.shape[:2]
    acc = np.full(x[1:-1, 1:-1].shape, np.float32(0.5))
    for dy in (1, 0, -1):
        row = x[1 + dy:h - 1 + dy]
        left, mid, right = row[:, :-2], row[:, 1:-1], row[:, 2:]
        acc += left * k + mid * (k5 if dy == 0 else k) + right * k
    out = img.copy()
    out[1:-1, 1:-1] = np.clip(acc, 0.0, 255.0).astype(np.uint8)
    return out


def _color_jitter(rng: np.random.Generator, img: np.ndarray,
                  brightness: float = 0.1,
                  contrast: float = 0.2) -> np.ndarray:
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    img = _blend(np.zeros_like(img), img, b)
    return _blend(np.full_like(img, _gray_mean(img)), img, c)


def _rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, expand=True)``: counter-clockwise about the
    centre, NEAREST, black outside the source."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270):
        return np.rot90(img, 1 if angle == 90 else 3).copy()
    h, w = img.shape[:2]
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b, d, e = (round(math.cos(rad), 15), round(math.sin(rad), 15),
                  round(-math.sin(rad), 15), round(math.cos(rad), 15))
    c = a * -cx + b * -cy + cx
    f = d * -cx + e * -cy + cy
    xs = [a * x + b * y + c for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
    ys = [d * x + e * y + f for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
    nw = math.ceil(max(xs)) - math.floor(min(xs))
    nh = math.ceil(max(ys)) - math.floor(min(ys))
    tx, ty = -(nw - w) / 2.0, -(nh - h) / 2.0
    c, f = a * tx + b * ty + c, d * tx + e * ty + f
    # PIL's affine_fixed: 16.16 fixed point, sampled at pixel centres
    a0, a1, a3, a4 = (math.floor(v * 65536.0 + 0.5) for v in (a, b, d, e))
    a2 = math.floor((c + b * 0.5 + a * 0.5) * 65536.0 + 0.5)
    a5 = math.floor((f + e * 0.5 + d * 0.5) * 65536.0 + 0.5)
    ys_, xs_ = np.mgrid[0:nh, 0:nw].astype(np.int64)
    xin = (a2 + ys_ * a1 + xs_ * a0) >> 16
    yin = (a5 + ys_ * a4 + xs_ * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros((nh, nw, 3), np.uint8)
    out[inside] = img[yin[inside], xin[inside]]
    return out


def apply_augmentations(rng: np.random.Generator, img: np.ndarray,
                        augmentation_list: Sequence[str]) -> np.ndarray:
    for aug in augmentation_list:
        if aug == "original":
            continue
        if aug == "vflip":
            if rng.random() < 0.4:
                img = img[::-1]
        elif aug == "hflip":
            if rng.random() < 0.4:
                img = img[:, ::-1]
        elif aug == "contrast":
            if rng.random() < 0.5:
                img = _autocontrast(img)
        elif aug == "jitter":
            img = _color_jitter(rng, img)
        elif aug == "rot90":
            img = _rotate(img, rng.uniform(-90.0, 90.0))
        elif aug == "brightness":
            if rng.random() < 0.5:
                img = _blend(_smooth(img), img, 1.6)
        else:
            raise ValueError(f"unknown augmentation {aug!r}")
    return np.ascontiguousarray(img)


def to_normalized_array(img: np.ndarray) -> np.ndarray:
    arr = img.astype(np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(rng: np.random.Generator, img: np.ndarray,
                    size: Tuple[int, int] = DEFAULT_SIZE,
                    augmentation_list: Sequence[str] = DEFAULT_AUGS
                    ) -> np.ndarray:
    img = _resize(img, size)
    img = apply_augmentations(rng, img, augmentation_list)
    img = _resize(img, size)
    return to_normalized_array(img)


def eval_transform(img: np.ndarray,
                   size: Tuple[int, int] = DEFAULT_SIZE) -> np.ndarray:
    return to_normalized_array(_resize(img, size))


def raw_resize_u8(img: np.ndarray,
                  size: Tuple[int, int] = DEFAULT_SIZE) -> np.ndarray:
    """Resize only -> (H, W, 3) uint8: the host half of the device-side
    augmentation split, which ships uint8 and augments on the device."""
    return np.ascontiguousarray(_resize(img, size))
