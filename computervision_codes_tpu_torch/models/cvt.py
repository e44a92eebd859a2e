"""CvT (Convolutional vision Transformer) backbone, eval and training.

Counterpart of ``models/cvt.py`` in the JAX package (the reference's
vendored ``cls_cvt.py``, selected by ``backbone='CvT_w24'``): three stages
of an overlapping conv embedding + LayerNorm, then transformer blocks whose
q/k/v tokens come from a depthwise 3x3 convolution + BatchNorm
(``ConvProjection``; k and v at stride 2), a cls token in the last stage
only. As there:

* the attention scores are scaled by ``dim ** -0.5`` (the stage's whole
  width, not the head's): q is multiplied by ``nh ** -0.5`` in the model's
  dtype before the attention, which scales by ``head_dim ** -0.5``;
* the attention runs ``multi_head_attention(..., backend="xla")``, the
  plain version on every device: the JAX model computes it outside any
  Pallas kernel, so no kernel of the port sits on this path;
* the MLP's activation is QuickGELU;
* stochastic depth ramps linearly over each stage's blocks and drops the
  spatial and cls tokens of a sample with one mask (``DropPathPair``);
* ``feature_map`` is the final LayerNorm of the spatial map and ``pooled``
  the same LayerNorm of the cls token; ``pre_norm_map`` and
  ``pre_norm_cls`` are their inputs.

The convolutions are ``F.conv2d`` (cuDNN on the card), as they were XLA
convolutions in the JAX package. In ``.train()`` each ``ConvProjection``'s
BatchNorm normalises with the batch statistics and moves its running
statistics at flax's momentum 0.9 (``models.resnet.BatchNorm``).

Inputs are NHWC frames, as in the JAX package. Child modules carry the
flax names (``embed{s}``, ``embed_norm{s}``, ``stage{s}_block{b}/attn/
proj_q/dw``, ``.../proj_q/bn``, ``attn/q`` ... ``attn/proj``, ``mlp/
Dense_0``, ``norm``, the parameter ``cls_token``) for
``models.convert.load_jax_variables``; their ``Dense`` layers are
``models.common.Dense``, which ``models.quant_dense`` swaps for int8.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.attention import multi_head_attention
from .common import Dense, LayerNorm, Mlp, keep_mask, lecun_normal_, \
    quick_gelu, trunc_normal_
from .resnet import BatchNorm, Conv2d

VARIANTS = {
    "cvt_w24": dict(dims=(192, 768, 1024), depths=(2, 2, 20),
                    heads=(3, 12, 16), drop_path=(0.0, 0.0, 0.3)),
    "cvt_13": dict(dims=(64, 192, 384), depths=(1, 2, 10), heads=(1, 3, 6),
                   drop_path=(0.0, 0.0, 0.1)),
    "cvt_nano": dict(dims=(16, 32, 64), depths=(1, 1, 2), heads=(1, 2, 4),
                     drop_path=(0.0, 0.0, 0.0)),
}


def _conv(cin: int, cout: int, k: int, stride: int, padding: int, dtype,
          generator, bias: bool = True, groups: int = 1) -> Conv2d:
    """flax ``nn.Conv`` with its default (lecun normal) kernel init."""
    conv = Conv2d(cin, cout, k, stride, padding, dtype, generator, bias,
                  groups)
    lecun_normal_(conv.weight.data, k * k * cin // groups, generator)
    return conv


class ConvProjection(nn.Module):
    """A bias-free depthwise 3x3 convolution (padding 1) then BatchNorm, on
    NHWC maps."""

    def __init__(self, dim: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw = _conv(dim, dim, 3, stride, 1, dtype, generator,
                        bias=False, groups=dim)
        self.bn = BatchNorm(dim, dtype)

    def forward(self, x):
        y = self.bn(self.dw(x.permute(0, 3, 1, 2)))
        return y.permute(0, 2, 3, 1)


class DropPathPair(nn.Module):
    """Stochastic depth over a (spatial, cls) residual pair with one
    Bernoulli(1 - rate) draw per sample for both; the identity in eval or
    at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, cls=None, generator=None):
        if not self.training or self.rate == 0.0:
            return x, cls
        keep = 1.0 - self.rate
        mask = keep_mask((x.shape[0],), keep, x.device, generator)

        def drop(t):
            m = mask.reshape((-1,) + (1,) * (t.ndim - 1))
            return torch.where(m, t / keep, torch.zeros_like(t))

        return drop(x), None if cls is None else drop(cls)


class CvTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, kv_stride: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_heads, self.dtype = num_heads, dtype
        self.proj_q = ConvProjection(dim, 1, dtype, g)
        self.proj_k = ConvProjection(dim, kv_stride, dtype, g)
        self.proj_v = ConvProjection(dim, kv_stride, dtype, g)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Dense(dim, dim, dtype=dtype, generator=g))

    def forward(self, x, cls=None):
        b, h, w, c = x.shape
        nh = self.num_heads

        def tokens(m):
            t = m.reshape(b, -1, c)
            return t if cls is None else torch.cat([cls, t], dim=1)

        q = self.q(tokens(self.proj_q(x)))
        k = self.k(tokens(self.proj_k(x)))
        v = self.v(tokens(self.proj_v(x)))

        def heads(t):
            return t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2)

        # the attention scales by head_dim ** -0.5; nh ** -0.5 on q makes
        # the reference's dim ** -0.5
        qh = heads(q) * torch.tensor(nh, dtype=self.dtype) ** -0.5
        out = multi_head_attention(qh, heads(k), heads(v), backend="xla")
        out = self.proj(out.transpose(1, 2).reshape(b, q.shape[1], c))
        if cls is None:
            return out.reshape(b, h, w, c), None
        return out[:, 1:].reshape(b, h, w, c), out[:, :1]


class CvTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = CvTAttention(dim, num_heads, dtype=dtype, generator=g)
        self.drop_path1 = DropPathPair(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, g, act=quick_gelu)
        self.drop_path2 = DropPathPair(drop_path)

    def forward(self, x, cls=None, generator=None):
        def both(fn, a, c):
            return fn(a), None if c is None else fn(c)

        xa, ca = self.attn(*both(self.norm1, x, cls))
        xa, ca = self.drop_path1(xa, ca, generator)
        x = x + xa
        cls = None if cls is None else cls + ca
        xm, cm = both(lambda t: self.mlp(self.norm2(t)), x, cls)
        xm, cm = self.drop_path2(xm, cm, generator)
        return x + xm, None if cls is None else cls + cm


class CvT(nn.Module):
    """Headless CvT: NHWC frames -> ``{"feature_map", "pooled",
    "pre_norm_map", "pre_norm_cls"}``."""

    def __init__(self, dims: Sequence[int] = (192, 768, 1024),
                 depths: Sequence[int] = (2, 2, 20),
                 heads: Sequence[int] = (3, 12, 16),
                 drop_path: Sequence[float] = (0.0, 0.0, 0.3),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dtype, self.depths = dtype, tuple(depths)
        cin = 3
        for si, (dim, depth, nh) in enumerate(zip(dims, depths, heads)):
            # the w24 yaml's PATCH_SIZE/STRIDE/PADDING: (7, 4, 2) then
            # (3, 2, 1)
            k, s, p = (7, 4, 2) if si == 0 else (3, 2, 1)
            self.add_module(f"embed{si}", _conv(cin, dim, k, s, p, dtype, g))
            self.add_module(f"embed_norm{si}", LayerNorm(dim, dtype))
            dpr = np.linspace(0.0, drop_path[si], depth)
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", CvTBlock(
                    dim, nh, drop_path=float(dpr[bi]), dtype=dtype,
                    generator=g))
            cin = dim
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, cin),
                                                    0.02, g))
        self.norm = LayerNorm(cin, dtype)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``generator``: where a training call draws its stochastic-depth
        masks (None: PyTorch's default generator)."""
        x = images.to(self.dtype)
        cls = None
        last = len(self.depths) - 1
        for si, depth in enumerate(self.depths):
            x = getattr(self, f"embed{si}")(x.permute(0, 3, 1, 2))
            x = getattr(self, f"embed_norm{si}")(x.permute(0, 2, 3, 1))
            if si == last:
                cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1,
                                                           -1)
            for bi in range(depth):
                x, cls = getattr(self, f"stage{si}_block{bi}")(x, cls,
                                                               generator)
        fm = self.norm(x)
        return {"feature_map": fm, "pooled": self.norm(cls)[:, 0],
                "pre_norm_map": x, "pre_norm_cls": cls}


def build_cvt(name: str, dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None) -> CvT:
    if name not in VARIANTS:
        raise ValueError(f"unknown cvt variant {name!r}; one of "
                         f"{list(VARIANTS)}")
    return CvT(dtype=dtype, generator=generator, **VARIANTS[name])


def feature_dim(name: str) -> int:
    """Channels of the last stage."""
    return VARIANTS[name]["dims"][-1]
