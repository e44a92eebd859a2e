"""TResNet backbone (anti-aliased SE-ResNet), eval and training forward.

Counterpart of ``models/tresnet.py`` in the JAX package (the reference's
``tresnet_sync.py:139-225``), with its structure: a 4x4 space-to-depth stem
then a 3x3 conv + ABN (LeakyReLU slope 1e-2); basic blocks in stages 1-2
and bottlenecks in 3-4, SE on stages 1-3; a stride-2 block anti-aliases
with a blur pool AFTER its stride-1 conv + ABN; the shortcut is an
AvgPool(2, ceil, excluding padding) then 1x1 conv + BatchNorm; the
post-residual activation is plain ReLU; each block's last ABN starts at
zero gamma.

``ABN`` is the eval form of InPlaceABN: the BatchNorm constants folded in
float32 and rounded to the compute dtype, then one
``ops.fused_norm.fused_scale_bias_act`` pass (K9 on the card: 52 launches
per TResNet-L forward); an ABN without activation is the plain BatchNorm.
In ``.train()`` an ABN is the JAX training ABN, plain torch as that is
plain XLA: BatchNorm on the batch statistics, which moves the running
statistics at flax's momentum 0.9 (``models.resnet.BatchNorm``), then the
leaky ReLU; K9 stays on the eval path.

Inputs at the public boundary are NHWC, as in the JAX package; inside, the
maps are NCHW in ``channels_last`` memory format (the port's ResNet does
the same), so the channel axis is innermost in memory and an NHWC view of
any map is dense, which is what K9 reads. The blur pool's depthwise
convolution may return another memory format; its result is put back in
``channels_last``.

Child modules carry the flax names (``stem_conv``, ``stem_abn/bn``,
``layer{s}_{b}/conv1``, ``abn1``, ``se/fc1``, ``downsample``,
``downsample_abn`` ...) for ``models.convert.load_jax_variables``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_norm import blur_pool, fused_scale_bias_act, space_to_depth
from .common import Dense, lecun_normal_
from .resnet import BN_EPS, BatchNorm, Conv2d

VARIANTS = {
    "tresnet_m": dict(width=64, layers=(3, 4, 11, 3)),
    "tresnet_l": dict(width=76, layers=(4, 5, 18, 3)),
    "tresnet_xl": dict(width=83, layers=(4, 5, 24, 3)),
}
CL = torch.channels_last


def _conv(cin: int, cout: int, k: int, dtype, generator) -> Conv2d:
    """Bias-free k x k conv, stride 1, padding k // 2, with flax's default
    (lecun normal) kernel init."""
    conv = Conv2d(cin, cout, k, 1, k // 2, dtype, generator)
    lecun_normal_(conv.weight.data, k * k * cin, generator)
    return conv


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """The shortcut's AvgPool(2, stride 2, ceil, padding excluded) over an
    NCHW map, as flax's ``avg_pool(padding="SAME",
    count_include_pad=False)`` computes it: the four taps summed one after
    another in x's dtype, then divided by the count of real taps (1, 2 or
    4, so exactly)."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, w % 2, 0, h % 2))
    s = xp[..., 0::2, 0::2] + xp[..., 0::2, 1::2]
    s = s + xp[..., 1::2, 0::2]
    s = s + xp[..., 1::2, 1::2]
    if h % 2 == 0 and w % 2 == 0:
        return s / 4
    ones = F.pad(torch.ones(h, w, device=x.device), (0, w % 2, 0, h % 2))
    count = ones.reshape(h // 2 + h % 2, 2, w // 2 + w % 2, 2).sum((1, 3))
    return s / count.to(x.dtype)


class ABN(nn.Module):
    """InPlaceABN: in eval ``leaky_relu(x * w + b)`` with w = scale /
    sqrt(var + eps) and b = bias - mean * w in float32, rounded to the
    compute dtype (``act``), or the plain BatchNorm (not ``act``); in
    training the batch-statistics BatchNorm, then the leaky ReLU (``act``)
    in the compute dtype."""

    def __init__(self, n: int, act: bool = True, slope: float = 1e-3,
                 zero_init: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act, self.slope, self.dtype = act, slope, dtype
        self.bn = BatchNorm(n, dtype)
        if zero_init:
            with torch.no_grad():
                self.bn.weight.zero_()

    def forward(self, x):
        if self.training or not self.act:
            y = self.bn(x)
            return F.leaky_relu(y, self.slope) if self.act else y
        bn = self.bn
        w = bn.weight * (bn.running_var + BN_EPS) ** -0.5
        b = bn.bias - bn.running_mean * w
        return _nchw(fused_scale_bias_act(_nhwc(x), w.to(x.dtype),
                                          b.to(x.dtype), self.slope))


class SEModule(nn.Module):
    """Squeeze-excitation: x * sigmoid(fc2(relu(fc1(mean_hw(x)))))."""

    def __init__(self, c: int, reduce: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(c, reduce, dtype=dtype, generator=generator)
        self.fc2 = Dense(reduce, c, dtype=dtype, generator=generator)

    def forward(self, x):
        s = torch.relu(self.fc1(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(s))[:, :, None, None]


class _Block(nn.Module):
    """The shortcut shared by both block kinds: AvgPool(2, ceil, exclude
    padding) at stride 2, then 1x1 conv + BatchNorm, when the stride or the
    width changes."""

    def _shortcut(self, cin, cout, stride, dtype, generator):
        self.stride = stride
        self.has_downsample = stride == 2 or cin != cout
        if self.has_downsample:
            self.downsample = _conv(cin, cout, 1, dtype, generator)
            self.downsample_abn = ABN(cout, act=False, dtype=dtype)

    def identity(self, x):
        if not self.has_downsample:
            return x
        if self.stride == 2:
            x = avg_pool_2x2(x)
        return self.downsample_abn(self.downsample(x))

    def blur(self, x):
        if self.stride != 2:
            return x
        return _nchw(blur_pool(_nhwc(x))).contiguous(memory_format=CL)


class TBasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 use_se: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv1 = _conv(cin, filters, 3, dtype, g)
        self.abn1 = ABN(filters, dtype=dtype)
        self.conv2 = _conv(filters, filters, 3, dtype, g)
        self.abn2 = ABN(filters, act=False, zero_init=True, dtype=dtype)
        self.use_se = use_se
        if use_se:
            self.se = SEModule(filters, max(filters // 4, 64), dtype, g)
        self._shortcut(cin, filters, stride, dtype, g)

    def forward(self, x):
        h = self.blur(self.abn1(self.conv1(x)))
        h = self.abn2(self.conv2(h))
        if self.use_se:
            h = self.se(h)
        return torch.relu(h + self.identity(x))


class TBottleneck(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 use_se: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        out_ch = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1, dtype, g)
        self.abn1 = ABN(filters, dtype=dtype)
        self.conv2 = _conv(filters, filters, 3, dtype, g)
        self.abn2 = ABN(filters, dtype=dtype)
        self.use_se = use_se
        if use_se:
            self.se = SEModule(filters, max(out_ch // 8, 64), dtype, g)
        self.conv3 = _conv(filters, out_ch, 1, dtype, g)
        self.abn3 = ABN(out_ch, act=False, zero_init=True, dtype=dtype)
        self._shortcut(cin, out_ch, stride, dtype, g)

    def forward(self, x):
        h = self.abn1(self.conv1(x))
        h = self.blur(self.abn2(self.conv2(h)))
        if self.use_se:
            h = self.se(h)
        h = self.abn3(self.conv3(h))
        return torch.relu(h + self.identity(x))


class TResNet(nn.Module):
    """Headless TResNet: NHWC frames -> ``{"stages": [NHWC maps], "pooled":
    (B, C)}``."""

    def __init__(self, width: int = 64, layers: Sequence[int] = (3, 4, 11, 3),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, g = dtype, generator
        self.stem_conv = _conv(48, width, 3, dtype, g)
        # the stem keeps conv2d_ABN's default slope 1e-2
        self.stem_abn = ABN(width, slope=1e-2, dtype=dtype)
        cin = width
        self.stage_names = []
        for si, depth in enumerate(layers):
            filters = width * 2 ** si
            block = TBasicBlock if si < 2 else TBottleneck
            names = []
            for bi in range(depth):
                name = f"layer{si + 1}_{bi}"
                self.add_module(name, block(
                    cin, filters, 2 if si > 0 and bi == 0 else 1, si < 3,
                    dtype, g))
                cin = filters * block.expansion
                names.append(name)
            self.stage_names.append(names)
        self.num_channels = cin

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC frames -> the stem's NCHW (channels_last) map."""
        x = _nchw(space_to_depth(x.to(self.dtype), 4))
        return self.stem_abn(self.stem_conv(x.contiguous(memory_format=CL)))

    def stage(self, si: int, x: torch.Tensor) -> torch.Tensor:
        for name in self.stage_names[si]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> Dict[str, object]:
        x = self.stem(x)
        stages = []
        for si in range(len(self.stage_names)):
            x = self.stage(si, x)
            stages.append(_nhwc(x))
        return {"stages": stages, "pooled": x.mean(dim=(2, 3))}


def build_tresnet(name: str, dtype: torch.dtype = torch.float32,
                  generator: Optional[torch.Generator] = None) -> TResNet:
    if name not in VARIANTS:
        raise ValueError(f"unknown tresnet variant {name!r}; one of "
                         f"{list(VARIANTS)}")
    return TResNet(dtype=dtype, generator=generator, **VARIANTS[name])


def feature_dim(name: str) -> int:
    """Channels of the last stage: width * 8 * 4 (bottleneck expansion)."""
    return VARIANTS[name]["width"] * 8 * 4
