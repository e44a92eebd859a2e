"""ResNet-18/34/50/101 backbones (torchvision architecture).

Counterpart of ``models/resnet.py`` in the JAX package: stem 7x7/2 conv ->
BN -> ReLU -> 3x3/2 max-pool, then BasicBlock or Bottleneck stages with a
1x1 conv + BN downsample shortcut, returning every stage output and the
pooled feature. In eval BatchNorm runs with its running statistics; in
``.train()`` it is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
(the JAX ``models/resnet.py:53``): the batch's mean and biased variance
normalise, and the running statistics move to ``0.9 * running + 0.1 *
batch`` (the biased variance too, where ``F.batch_norm`` would take the
unbiased one). ``frozen_bn`` keeps the eval arithmetic in a separate
``frozen`` collection in both modes, as the JAX FrozenBatchNorm does.
A convolution's ``weight_fn`` (None by default) replaces its weight by
``weight_fn(weight)`` at each call: the QAT fake-quant
(``models/qat.py``).

Inputs at the public boundary are NHWC, as in the JAX package; inside, the
tensors are NCHW in ``channels_last`` memory format, which is the same
bytes. Convolutions are cuDNN's on the card, as they were XLA's on the TPU:
no Pallas kernel sits on this path at its defaults.

Two execution plans of the stem, both off by default and with the JAX
package's gates: ``fused_stem`` folds the eval BatchNorm into the stem in
float32 and runs conv + bias + ReLU + max-pool as one kernel
(``ops.stem_pool.stem_pool_fused``), when H and W are divisible by 4;
otherwise ``s2d_stem`` runs the 7x7/2 conv as a 4x4/1 conv over the 2x2
space-to-depth input (``_s2d_conv1``), when H and W are even. ``fused_stem``
wins when both are set.

Child modules carry the flax names (``conv1``, ``bn1``, ``layer1_0``,
``downsample_conv`` ...) for ``models.convert.load_jax_variables``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stem_pool import stem_pool_fused

BN_EPS = 1e-5


class Conv2d(nn.Module):
    """Conv, weight OIHW, initialised as the JAX package's
    ``variance_scaling(2.0, "fan_out", "normal")``; bias-free unless
    ``bias`` (zeros, as flax's ``Conv``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 bias: bool = False):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        std = math.sqrt(2.0 / (kernel * kernel * cout))
        w = torch.empty(cout, cin, kernel, kernel)
        self.weight = nn.Parameter(nn.init.normal_(w, 0.0, std,
                                                   generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.weight_fn = None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight if self.weight_fn is None else self.weight_fn(
            self.weight)
        return F.conv2d(x, w.to(self.dtype), b, self.stride, self.padding)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW maps. Eval: y = x * w + b, with w = weight /
    sqrt(var + eps) and b = bias - mean * w computed in float32, then cast
    to the compute dtype. Training (``.train()``): flax's batch statistics
    in float32 (mean, and the variance max(0, mean(x^2) - mean^2)),
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in float32, cast
    to the compute dtype, and the running statistics updated in place.
    ``weight`` and ``bias`` are parameters (flax's ``scale`` and ``bias``),
    the statistics buffers."""

    collection = "batch_stats"
    momentum = 0.9

    def __init__(self, n: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self._affine("weight", torch.ones(n))
        self._affine("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def _affine(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value))

    def forward(self, x):
        if self.training:
            return self.batch_forward(x)
        return self.eval_forward(x)

    def eval_forward(self, x):
        w = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        b = self.bias - self.running_mean * w
        shape = (1, -1, 1, 1)
        return x * w.to(self.dtype).view(shape) + b.to(self.dtype).view(shape)

    def batch_forward(self, x):
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class FrozenBatchNorm(BatchNorm):
    """BatchNorm whose four vectors come from the JAX ``frozen`` collection:
    buffers, and the eval arithmetic in training too."""

    collection = "frozen"

    def _affine(self, name: str, value: torch.Tensor) -> None:
        self.register_buffer(name, value)

    def forward(self, x):
        return self.eval_forward(x)


def _norm(frozen: bool) -> Type[BatchNorm]:
    return FrozenBatchNorm if frozen else BatchNorm


def _s2d_conv1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The stem conv (7x7, stride 2, pad 3) as a 4x4 stride-1 VALID conv
    over the 2x2 space-to-depth input, on the same kernel: tap (dy, dx)
    maps to spatial (dy // 2, dx // 2) and input channel (dy % 2, dx % 2,
    c). Identical multiply-adds; needs even H, W.

    x: (N, C, H, W) (any memory format); kernel: OIHW (64, C, 7, 7).
    Returns (N, 64, H/2, W/2).
    """
    n, c, h, w = x.shape
    oc = kernel.shape[0]
    xp = F.pad(x, (3, 3, 3, 3))
    hp, wp = h + 6, w + 6
    # (n, c, hp/2, 2, wp/2, 2) -> channels ordered (py, px, c)
    xs = xp.reshape(n, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(n, 4 * c, hp // 2, wp // 2)
    kp = F.pad(kernel, (0, 1, 0, 1))  # zero tap 7 -> (oc, c, 8, 8)
    k2 = kp.reshape(oc, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    k2 = k2.reshape(oc, 4 * c, 4, 4)
    return F.conv2d(xs, k2)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 frozen_bn: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, norm = generator, _norm(frozen_bn)
        self.conv1 = Conv2d(cin, filters, 3, stride, 1, dtype, g)
        self.bn1 = norm(filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, dtype, g)
        self.bn2 = norm(filters, dtype)
        self.has_downsample = cin != filters or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, filters, 1, stride, 0, dtype, g)
            self.downsample_bn = norm(filters, dtype)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to ``filters * 4`` channels."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 frozen_bn: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, norm = generator, _norm(frozen_bn)
        out_ch = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1, 1, 0, dtype, g)
        self.bn1 = norm(filters, dtype)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, dtype, g)
        self.bn2 = norm(filters, dtype)
        self.conv3 = Conv2d(filters, out_ch, 1, 1, 0, dtype, g)
        self.bn3 = norm(out_ch, dtype)
        self.has_downsample = cin != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, out_ch, 1, stride, 0, dtype, g)
            self.downsample_bn = norm(out_ch, dtype)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Headless ResNet: NHWC frames -> ``{"stages": [NHWC maps], "pooled":
    (N, C)}``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[nn.Module],
                 frozen_bn: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 s2d_stem: bool = False, fused_stem: bool = False):
        super().__init__()
        self.dtype = dtype
        self.s2d_stem, self.fused_stem = s2d_stem, fused_stem
        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype, generator)
        self.bn1 = _norm(frozen_bn)(64, dtype)
        cin = 64
        self.stage_names = []
        for si, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** si
            names = []
            for bi in range(num_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                name = f"layer{si + 1}_{bi}"
                self.add_module(name, block_cls(cin, filters, stride,
                                                frozen_bn, dtype, generator))
                cin = filters * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)
        self.num_channels = cin

    def stem_bn_fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w', b'): the stem kernel, HWIO (7, 7, 3, 64), with the eval
        BatchNorm folded in, and the folded bias; float32."""
        bn = self.bn1
        mult = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        kernel = self.conv1.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
        return kernel * mult, bn.bias - bn.running_mean * mult

    def forward(self, x: torch.Tensor) -> Dict[str, object]:
        x = x.to(self.dtype)
        h, w = x.shape[1], x.shape[2]
        if self.fused_stem and h % 4 == 0 and w % 4 == 0:
            wf, bf = self.stem_bn_fold()
            x = stem_pool_fused(x.contiguous(), wf.to(self.dtype), bf)
            x = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        else:
            # NHWC -> NCHW view with channels_last strides (no copy when x
            # is a contiguous NHWC tensor)
            x = x.permute(0, 3, 1, 2)
            x = x.contiguous(memory_format=torch.channels_last)
            if self.s2d_stem and h % 2 == 0 and w % 2 == 0:
                x = _s2d_conv1(x, self.conv1.weight.to(self.dtype))
            else:
                x = self.conv1(x)
            x = torch.relu(self.bn1(x))
            x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            stages.append(x.permute(0, 2, 3, 1))
        return {"stages": stages, "pooled": x.mean(dim=(2, 3))}


VARIANTS: Dict[str, Tuple[Sequence[int], Type[nn.Module]]] = {
    "resnet18": ((2, 2, 2, 2), BasicBlock),
    "resnet34": ((3, 4, 6, 3), BasicBlock),
    "resnet50": ((3, 4, 6, 3), Bottleneck),
    "resnet101": ((3, 4, 23, 3), Bottleneck),
}


def build_resnet(name: str, frozen_bn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 s2d_stem: bool = False, fused_stem: bool = False) -> ResNet:
    if name not in VARIANTS:
        raise ValueError(f"unknown resnet variant {name!r}; one of "
                         f"{list(VARIANTS)}")
    sizes, block = VARIANTS[name]
    return ResNet(sizes, block, frozen_bn, dtype, generator, s2d_stem,
                  fused_stem)


def feature_dim(name: str) -> int:
    sizes, block = VARIANTS[name]
    return 512 * block.expansion
