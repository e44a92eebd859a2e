"""Shared model helpers; counterpart of ``models/common.py`` in the JAX package.

The transformer building blocks keep flax's conventions, so that
``models.convert.load_jax_variables`` fills them by name and the tests
compare like with like: parameters are float32 and cast to the compute
``dtype`` at each call; a ``Dense`` holds ``kernel`` (in, out) and ``bias``;
a ``LayerNorm`` holds ``scale`` and ``bias``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mlp_block import layer_norm_f32

# a unit normal truncated to [-2, 2] has this standard deviation; flax's
# truncated_normal divides by it so that the drawn values have ``stddev``
TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, stddev: float = 0.02,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax ``truncated_normal(stddev, lower=-2, upper=2)``, drawn from a
    ``torch.Generator`` (values differ from JAX's; the distribution is the
    same)."""
    s = stddev / TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax's default ``Dense``/``Conv`` kernel init (truncated normal of
    variance 1 / fan_in)."""
    return trunc_normal_(t, 1.0 / math.sqrt(fan_in), generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ kernel + bias in the compute dtype, with
    ``kernel`` (in, out) in the flax layout."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init: str = "lecun"):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(cin, cout)
        if init == "trunc_normal":
            trunc_normal_(w, 0.02, generator)
        else:
            lecun_normal_(w, cin, generator)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Classifier(nn.Module):
    """A single linear head over a flat feature, as the JAX ``Classifier``
    (reference MT4MTLKD/Spatial_cnn/network.py:121-129): its ``Dense`` is
    the child ``fc``."""

    def __init__(self, cin: int, num_classes: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = Dense(cin, num_classes, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1))


class TemporalConv(nn.Module):
    """flax ``nn.Conv(cout, (k,), padding=k // 2, feature_group_count=
    groups)`` over (B, T, C) in the compute dtype: the convolution rounds
    to the dtype, then the bias is added in it, as flax does. ``kernel`` is
    (k, Cin / groups, Cout), flax's layout; lecun-normal init with zero
    bias, as flax's defaults.

    A dense convolution (groups 1) runs as one GEMM over the k shifted
    copies of x side by side, (B, T, k Cin) @ (k Cin, Cout), the kernel's
    reshape a view, with the float32 sums a convolution takes: on the card
    cuBLAS, not cuDNN, which plans anew for every sequence length (the
    driver's every video; ``scripts/mstct_merge_conv_probe.py``). A grouped
    one (MS-TCT's depthwise ``tc``) runs as ``F.conv1d``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.groups = dtype, groups
        w = torch.empty(kernel, cin // groups, cout)
        lecun_normal_(w, kernel * (cin // groups), generator)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        k, cout = w.shape[0], w.shape[-1]
        if self.groups == 1:
            t = x.shape[1]
            xp = F.pad(x, (0, 0, k // 2, k // 2))  # pads time
            cols = torch.cat([xp[:, i:i + t] for i in range(k)], dim=-1)
            y = cols @ w.reshape(-1, cout)
        else:
            y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0),
                         padding=k // 2, groups=self.groups).transpose(1, 2)
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-5): statistics and the affine map in
    float32, the result in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm_f32(x, self.scale, self.bias).to(self.dtype)


class Mlp(nn.Module):
    """Transformer MLP (Dense -> exact GELU -> Dense; no dropout, the Swin
    models' rate being 0). The children carry flax's auto names
    ``Dense_0`` and ``Dense_1``."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, dtype=dtype, generator=generator,
                             init="trunc_normal")
        self.Dense_1 = Dense(hidden, dim, dtype=dtype, generator=generator,
                             init="trunc_normal")

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))  # exact (erf) GELU


def keep_mask(shape, keep: float, device,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Bernoulli(``keep``) booleans of ``shape`` on ``device``, drawn from
    ``generator`` (one on ``device``; None draws from PyTorch's default)."""
    return torch.rand(shape, device=device, generator=generator) < keep


def drop(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """x / keep where ``mask`` holds, else 0, in x's dtype (flax's
    ``jnp.where(mask, x / keep, 0)``)."""
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth, as the JAX ``DropPath``: in training one
    Bernoulli(1 - rate) draw per sample, then x / (1 - rate) or 0; the
    identity in eval or at rate 0. ``draw`` makes a call's mask and
    ``forward`` applies it, so that a checkpointed block (Swin's remat)
    replays with the masks drawn once outside it."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Optional[torch.Tensor]:
        """The per-sample keep mask (B, 1, ..., 1) of one training call on
        x, or None where the module is the identity."""
        if not self.training or self.rate == 0.0:
            return None
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return keep_mask(shape, 1.0 - self.rate, x.device, generator)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        """``mask``: what ``draw`` gave for this call (None: identity)."""
        return x if mask is None else drop(x, mask, 1.0 - self.rate)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in eval
    or at rate 0. The mask comes from the caller's generator, which
    ``torch.nn.Dropout`` does not take."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return drop(x, keep_mask(x.shape, keep, x.device, generator), keep)


class GroupWiseLinear(nn.Module):
    """Per-class readout out[b, k] = <W[k], x[b, k]> + b[k], the product and
    the sum in the compute dtype; init U(-1/sqrt(d), 1/sqrt(d))."""

    def __init__(self, num_class: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(hidden_dim)

        def uniform(*shape):
            return nn.Parameter(
                torch.rand(*shape, generator=generator) * 2 * bound - bound)

        self.W = uniform(num_class, hidden_dim)
        self.b = uniform(num_class)

    def forward(self, x):  # x (B, K, D)
        out = (self.W.to(self.dtype) * x.to(self.dtype)).sum(-1)
        return out + self.b.to(self.dtype)


def interpolate_1d(x: torch.Tensor, size: int, mode: str = "linear"
                   ) -> torch.Tensor:
    """Resize (B, C, T) tensors over T, as the JAX ``interpolate_1d``.

    * ``linear``: half-pixel centres (torch align_corners=False).
    * ``nearest``: the floor rule src = floor(dst * T_in / T_out).
    """
    t_in = x.shape[-1]
    if t_in == size:
        return x
    pos = torch.arange(size, dtype=torch.float32, device=x.device)
    if mode == "nearest":
        idx = torch.floor(pos * (t_in / size)).long().clamp(0, t_in - 1)
        return x[:, :, idx]
    if mode == "linear":
        src = ((pos + 0.5) * (t_in / size) - 0.5).clamp(0.0, t_in - 1)
        lo = torch.floor(src).long()
        hi = (lo + 1).clamp(max=t_in - 1)
        w = (src - lo).to(x.dtype)
        return x[:, :, lo] * (1 - w) + x[:, :, hi] * w
    raise ValueError(f"unsupported mode {mode!r}")
