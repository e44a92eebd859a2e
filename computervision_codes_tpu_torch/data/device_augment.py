"""Train-time augmentation on the device over uint8 frames.

Counterpart of ``data/device_augment.py`` in the JAX package. The reference
augments on the host with PIL (MT4MTLKD/Spatial_cnn/dataloader.py:89-97:
vflip p=0.4, hflip p=0.4, 'contrast' = RandomAutocontrast p=0.5, a
uniform(-90, 90) degree rotation with expansion); here the host only
decodes and resizes, ships uint8 frames, and the augmentation and the
ImageNet normalisation run as tensor ops on the frames' device, as the JAX
package runs them as XLA ops in its step (no Pallas kernel, so no kernel of
the port either). What each op computes is the JAX op's:

* flips are exact selects; ``autocontrast_u8`` is PIL's per-channel ramp
  applied to the pixels in float32, truncated;
* ``rotate_expand_resize_u8`` (``rot_impl="gather"``, the default)
  collapses PIL's ``rotate(angle, expand=True)`` and the resize back to
  the input shape into one bilinear affine warp with black outside;
  ``rotate_expand_resize_fast`` (``"two_pass"``, the JAX package's
  default) computes the same map as two 1-D passes (a per-line shift,
  then a per-sample scale as a product with a bilinear-hat matrix), on the
  input for |angle| <= 45 and on its rot90 beyond, each pass's sizes
  bounded from a grid of angles (``_pass_bounds``). On the H100 the
  gather warp takes half the two-pass time for the whole default list
  (PERF.md), so the port defaults to it;
* ``sharpness_u8`` and ``jitter_u8`` are ``ImageEnhance``'s Sharpness,
  Brightness and Contrast on PIL's integer conventions;
* ``normalize_u8`` is the ImageNet normalisation in float32.

Every random draw is split from its application: ``draw_augment`` makes
one batch's numbers, in list order, from a ``torch.Generator`` on the
frames' device, and ``apply_augment`` applies given numbers, so that a test
can give the port the numbers that JAX drew. ``make_device_augment``
returns ``(generator, uint8 (B, H, W, 3)) -> normalised (B, H, W, 3)``, or
with ``two_view`` two independently augmented views of the same frames
(TERL's two-crop protocol) from one upload.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import axis_size, local_slice
from .transforms import DEFAULT_AUGS, IMAGENET_MEAN, IMAGENET_STD

# augmentation -> probability of applying it per sample (the others draw
# their factors for every sample)
PROBS = {"vflip": 0.4, "hflip": 0.4, "contrast": 0.5, "brightness": 0.5}
ANGLE_RANGE = (-90.0, 90.0)  # rot90
JITTER_RANGES = ((0.9, 1.1), (0.8, 1.2))  # brightness, contrast factors
KNOWN = {"original", "vflip", "hflip", "contrast", "rot90", "brightness",
         "jitter"}


def normalize_u8(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> ImageNet-normalised float in float32, then
    ``dtype``."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


def autocontrast_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL ``ImageOps.autocontrast(cutoff=0)`` on uint8 (B, H, W, 3): per
    channel trunc((x - lo) * 255 / (hi - lo)), a channel with hi == lo left
    as it is."""
    f = x.float()
    lo = f.amin(dim=(1, 2), keepdim=True)
    hi = f.amax(dim=(1, 2), keepdim=True)
    flat = hi <= lo
    scale = 255.0 / torch.where(flat, torch.ones_like(hi), hi - lo)
    y = torch.trunc((f - lo) * scale).clamp(0.0, 255.0)
    return torch.where(flat, f, y).to(torch.uint8)


def _bilinear_sample(img: torch.Tensor, yi: torch.Tensor,
                     xi: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at float coordinates (B, Ho, Wo), zero outside;
    float32 (B, Ho, Wo, C)."""
    b, h, w, _ = img.shape
    y0, x0 = torch.floor(yi), torch.floor(xi)
    wy, wx = (yi - y0)[..., None], (xi - x0)[..., None]
    f = img.float()
    batch = torch.arange(b, device=img.device)[:, None, None]

    def tap(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        return f[batch, yc, xc] * valid[..., None]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _to_u8(out: torch.Tensor) -> torch.Tensor:
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _radians(angles_deg: torch.Tensor):
    a = torch.deg2rad(angles_deg.float())
    return torch.cos(a), torch.sin(a)


def rotate_expand_resize_u8(x: torch.Tensor,
                            angles_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample rotation with expansion, resized back to the input shape
    (the reference's ``img.rotate(angle, expand=True)`` then its second
    ``Resize``) as one bilinear warp; black outside the source."""
    b, h, w, _ = x.shape
    ca, sa = (t.reshape(b, 1, 1) for t in _radians(angles_deg))
    we = torch.abs(w * ca) + torch.abs(h * sa)
    he = torch.abs(w * sa) + torch.abs(h * ca)
    yo, xo = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device),
        indexing="ij")
    # output pixel centres -> canvas coordinates (the resize back)
    xc = (xo[None] + 0.5) * (we / w) - 0.5 - (we - 1) / 2.0
    yc = (yo[None] + 0.5) * (he / h) - 0.5 - (he - 1) / 2.0
    # the inverse rotation about the centres; PIL's positive angle turns
    # counterclockwise
    xi = ca * xc - sa * yc + (w - 1) / 2.0
    yi = sa * xc + ca * yc + (h - 1) / 2.0
    return _to_u8(_bilinear_sample(x, yi, xi))


def _rotate_coeffs(ca, sa, hs: int, ws: int, h: int, w: int):
    """The affine map (output pixel -> source pixel) of rotate(angle,
    expand=True) + Resize((h, w)) of an (hs, ws) source: (a, b, c, d, e, f)
    with x_src = a x + b y + c, y_src = d x + e y + f. Takes torch tensors
    or numpy arrays."""
    we = abs(ws * ca) + abs(hs * sa)
    he = abs(ws * sa) + abs(hs * ca)
    u0 = 0.5 * we / w - 0.5 - (we - 1) / 2.0
    v0 = 0.5 * he / h - 0.5 - (he - 1) / 2.0
    return (ca * we / w, -sa * he / h, ca * u0 - sa * v0 + (ws - 1) / 2.0,
            sa * we / w, ca * he / h, sa * u0 + ca * v0 + (hs - 1) / 2.0)


def _rot90_coeffs(coeffs, w: int):
    """The same map re-expressed on the rot90'd source: src'[i, j] =
    src[j, ws - 1 - i], so x' = y_src and y' = ws - 1 - x_src."""
    a, b, c, d, e, f = coeffs
    return d, e, f, -a, -b, (w - 1) - c


def _pass_bounds(coeffs, hs: int, ws: int, h: int, w: int):
    """Worst-case sizes of the two passes over a grid of angles (numpy
    arrays of coefficients): the first pass's resample width U1 and line
    pad P1, then the second's U2 and P2 (static ints)."""
    a, b, c, d, e, f = coeffs
    al1 = (a * e - b * d) / e
    be1 = b / e
    ga1 = c - b * f / e
    off1 = np.minimum(0.0, al1 * (w - 1))
    u1 = int(np.ceil(np.abs(al1 * (w - 1)).max())) + 2
    d1 = np.concatenate([ga1 + off1, be1 * (hs - 1) + ga1 + off1])
    p1 = int(np.ceil(max(-d1.min(), d1.max() + u1 - ws, 1.0))) + 2
    off2 = np.minimum(0.0, e * (h - 1))
    u2 = int(np.ceil(np.abs(e * (h - 1)).max())) + 2
    d2 = np.concatenate([f + off2, d * (w - 1) + f + off2])
    p2 = int(np.ceil(max(-d2.min(), d2.max() + u2 - hs, 1.0))) + 2
    return u1, p1, u2, p2


def _angle_grid(lo: float, hi: float):
    th = np.deg2rad(np.concatenate([np.linspace(lo, hi, 721),
                                    np.linspace(-hi, -lo, 721)]))
    return np.cos(th), np.sin(th)


def _line_shift(lines: torch.Tensor, delta: torch.Tensor, span: int,
                pad: int) -> torch.Tensor:
    """lines (B, L, S, C) -> float32 (B, L, span, C) with out[b, l, u] =
    lines[b, l, u + delta[b, l]], bilinear along S, zero outside: a
    contiguous run of span + 1 per line, blended by the fractional
    shift."""
    b, l, s, c = lines.shape
    padded = F.pad(lines, (0, 0, pad, pad))
    k = torch.floor(delta)
    frac = (delta - k)[..., None, None].float()
    start = (k.to(torch.int32) + pad).clamp(0, s + 2 * pad - span - 1)
    idx = start[..., None].long() + torch.arange(span + 1,
                                                 device=lines.device)
    sl = torch.gather(padded, 2, idx[..., None].expand(-1, -1, -1, c))
    sl = sl.float()
    return sl[:, :, :span] * (1 - frac) + sl[:, :, 1:] * frac


def _scale_lines(t: torch.Tensor, alpha: torch.Tensor, off: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """t (B, L, U, C) -> (B, L, n_out, C): a per-sample 1-D resample at
    alpha x - off, as a float32 product with the bilinear-hat matrix."""
    u = t.shape[2]
    x = torch.arange(n_out, dtype=torch.float32, device=t.device)
    q = alpha[:, None] * x[None, :] - off[:, None]  # (B, n_out)
    ui = torch.arange(u, dtype=torch.float32, device=t.device)
    hat = torch.clamp_min(1.0 - torch.abs(ui[None, :, None] - q[:, None, :]),
                          0.0)
    return torch.einsum("bluc,bux->blxc", t.float(), hat)


def _two_pass_warp(src: torch.Tensor, coeffs, h: int, w: int,
                   bounds) -> torch.Tensor:
    """out[b, y, x] = src[b, d x + e y + f, a x + b y + c] (bilinear, zero
    outside) in two passes: tmp[v, x] = src[v, al1 x + be1 v + ga1], then
    out[y, x] = tmp[e y + (d x + f), x]; valid while |e| stays away from
    0."""
    a, b_, c, d, e, f = coeffs
    hs = src.shape[1]
    u1, p1, u2, p2 = bounds
    al1 = (a * e - b_ * d) / e
    be1 = b_ / e
    ga1 = c - b_ * f / e
    off1 = torch.clamp_max(al1 * (w - 1), 0.0)
    v = torch.arange(hs, dtype=torch.float32, device=src.device)
    t1 = _line_shift(src, be1[:, None] * v[None, :] + (ga1 + off1)[:, None],
                     u1, p1)  # (B, hs, U1, C)
    tmp = _scale_lines(t1, al1, off1, w)  # (B, hs, w, C)
    off2 = torch.clamp_max(e * (h - 1), 0.0)
    xs = torch.arange(w, dtype=torch.float32, device=src.device)
    cols = tmp.transpose(1, 2)  # (B, w, hs, C)
    t2 = _line_shift(cols, d[:, None] * xs[None, :] + (f + off2)[:, None],
                     u2, p2)  # (B, w, U2, C)
    return _scale_lines(t2, e, off2, h).transpose(1, 2)  # (B, h, w, C)


def rotate_expand_resize_fast(x: torch.Tensor,
                              angles_deg: torch.Tensor) -> torch.Tensor:
    """``rotate_expand_resize_u8``'s map as two 1-D passes (shift, then a
    product with a hat matrix) instead of a per-pixel 2-D gather. Both
    branches run for every sample and each sample takes one: |angle| <= 45
    on the input, beyond on its rot90 with the map re-expressed (|e| >=
    cos 45 in both)."""
    _, h, w, _ = x.shape
    ca, sa = _radians(angles_deg)
    grid_a = _angle_grid(0.0, 46.0)
    bounds_a = _pass_bounds(_rotate_coeffs(*grid_a, h, w, h, w), h, w, h, w)
    coeffs = _rotate_coeffs(ca, sa, h, w, h, w)
    out_a = _two_pass_warp(x, coeffs, h, w, bounds_a)
    grid_b = _angle_grid(44.0, 90.0)
    bounds_b = _pass_bounds(
        _rot90_coeffs(_rotate_coeffs(*grid_b, h, w, h, w), w), w, h, h, w)
    out_b = _two_pass_warp(torch.rot90(x, 1, dims=(1, 2)),
                           _rot90_coeffs(coeffs, w), h, w, bounds_b)
    small = (torch.abs(angles_deg) <= 45.0)[:, None, None, None]
    return _to_u8(torch.where(small, out_a, out_b))


def sharpness_u8(x: torch.Tensor, factor: float = 1.6) -> torch.Tensor:
    """PIL ``ImageEnhance.Sharpness(factor)`` on uint8 (B, H, W, 3): a
    blend toward the SMOOTH filter (3x3 ((1,1,1),(1,5,1),(1,1,1)) / 13),
    which PIL rounds to uint8 first; the one-pixel border unfiltered."""
    _, h, w, _ = x.shape
    f = x.float()
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     device=x.device) / 13.0
    # the nine taps summed in float32 (a convolution could take TF32 on
    # the card, and TF32's 1/13 moves the rounding below)
    padded = F.pad(f, (0, 0, 1, 1, 1, 1))
    smooth = sum(padded[:, dy:dy + h, dx:dx + w] * k[dy, dx]
                 for dy in range(3) for dx in range(3))
    smooth = torch.floor(smooth + 0.5).clamp(0, 255)
    out = torch.floor(smooth + factor * (f - smooth) + 0.5).clamp(0, 255)
    ys = torch.arange(h, device=x.device)
    xs = torch.arange(w, device=x.device)
    interior = (((ys > 0) & (ys < h - 1))[:, None]
                & ((xs > 0) & (xs < w - 1))[None, :])[None, :, :, None]
    return torch.where(interior, out, f).to(torch.uint8)


def jitter_u8(x: torch.Tensor, brightness: torch.Tensor,
              contrast: torch.Tensor) -> torch.Tensor:
    """PIL ``ImageEnhance.Brightness`` (a blend toward black, truncated)
    then ``.Contrast`` (toward the rounded mean of the ITU-R 601-2 L
    conversion, truncated), with per-sample factors (B,)."""
    f = x.float()
    bf = brightness.reshape(-1, 1, 1, 1).float()
    cf = contrast.reshape(-1, 1, 1, 1).float()
    f = torch.trunc(f * bf).clamp(0, 255)
    # PIL's L: (r 19595 + g 38470 + b 7471 + 0x8000) >> 16
    lum = torch.floor((f[..., 0] * 19595 + f[..., 1] * 38470
                       + f[..., 2] * 7471 + 32768) / 65536.0)
    mean = torch.floor(lum.mean(dim=(1, 2), keepdim=True) + 0.5)[..., None]
    return torch.trunc(mean + cf * (f - mean)).clamp(0, 255).to(torch.uint8)


def _check(augs: Sequence[str]) -> None:
    for aug in augs:
        if aug not in KNOWN:
            raise ValueError(
                f"unknown/host-only augmentation for the device path: "
                f"{aug!r} (supported: {sorted(KNOWN)})")


def draw_augment(augmentation_list: Sequence[str], batch: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> List:
    """One batch's random numbers, in list order, from ``generator`` (one
    on ``device``): per augmentation None ("original"), a bool (B,) mask
    (the flips, "contrast", "brightness"), float32 (B,) angles in degrees
    ("rot90") or a pair of float32 (B,) factors ("jitter": brightness,
    contrast)."""
    _check(augmentation_list)

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=generator, device=device)
        return lo + (hi - lo) * u

    draws: List = []
    for aug in augmentation_list:
        if aug == "original":
            draws.append(None)
        elif aug in PROBS:
            draws.append(uniform() < PROBS[aug])
        elif aug == "rot90":
            draws.append(uniform(*ANGLE_RANGE))
        else:  # jitter
            draws.append(tuple(uniform(*r) for r in JITTER_RANGES))
    return draws


def apply_augment(augmentation_list: Sequence[str], x: torch.Tensor,
                  draws: Sequence, dtype=torch.float32,
                  rot_impl: str = "gather") -> torch.Tensor:
    """Apply ``draws`` (what ``draw_augment`` gives) to uint8 (B, H, W, 3)
    in list order, then normalise to ``dtype``."""
    rot_fn = {"two_pass": rotate_expand_resize_fast,
              "gather": rotate_expand_resize_u8}[rot_impl]
    _check(augmentation_list)
    ops = {"vflip": lambda t: t.flip(1), "hflip": lambda t: t.flip(2),
           "contrast": autocontrast_u8, "brightness": sharpness_u8}
    for aug, d in zip(augmentation_list, draws):
        if aug in ops:
            x = torch.where(d.reshape(-1, 1, 1, 1), ops[aug](x), x)
        elif aug == "rot90":
            x = rot_fn(x, d)
        elif aug == "jitter":
            x = jitter_u8(x, *d)
    return normalize_u8(x, dtype)


def make_device_augment(augmentation_list: Sequence[str] = DEFAULT_AUGS,
                        dtype=torch.float32, two_view: bool = False,
                        rot_impl: str = "gather", sharding=None):
    """``(generator, uint8 (B, H, W, 3)) -> normalised (B, H, W, 3)
    dtype``, the reference's train augmentations in list order with
    per-sample draws from ``generator`` (on the frames' device); with
    ``two_view`` a pair of independently augmented views of the same
    frames (the first view's numbers drawn first). ``rot_impl``:
    "gather" (default) or "two_pass". With ``sharding``
    (``parallel.mesh.batch_sharding``) the frames are this rank's rows of
    a global batch: the numbers are drawn for the whole batch from the
    same generator on every rank, and each draw keeps this rank's rows, so
    that every sample is augmented as on one device. A host-only or
    unknown augmentation raises ``ValueError`` here."""
    augs = tuple(augmentation_list)
    _check(augs)
    if rot_impl not in ("two_pass", "gather"):
        raise ValueError(f"unknown rot_impl {rot_impl!r}")

    def local(d):
        """This rank's rows of one draw (None, a tensor or a pair)."""
        if sharding is None or d is None:
            return d
        if isinstance(d, tuple):
            return tuple(local(x) for x in d)
        return local_slice(d, sharding)

    def one(generator, images):
        rows = images.shape[0] * (1 if sharding is None else axis_size(
            sharding.mesh, sharding.spec[0]))
        draws = draw_augment(augs, rows, generator, images.device)
        return apply_augment(augs, images, [local(d) for d in draws],
                             dtype, rot_impl)

    if two_view:
        def augment2(generator, images):
            return one(generator, images), one(generator, images)

        return augment2
    return one


def step_generator(device, base: int, *folds: int) -> torch.Generator:
    """A generator on ``device`` for one step's draws: seeded from the
    driver's ``base`` and the step's indices (``folds``: epoch, step ...),
    in the order the JAX drivers fold them into their key."""
    seed = base
    for i in folds:
        seed = (seed * 1_000_003 + i + 1) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)
