"""Int8 post-training-quantized TResNet (inference/serving path).

Counterpart of ``models/quant_tresnet.py`` in the JAX package: the ResNet
PTQ of ``models.quantized`` extended to the TResNet backbone
(``models.tresnet``). Every (conv, ABN) pair folds into per-channel int8
weights and a dequant affine carrying the BatchNorm constants
(``ops.quant.fold_bn``), with the ABN's leaky ReLU as the epilogue: slope
1e-2 for the stem, 1e-3 for the blocks, none where the ABN has no
activation (each block's last ABN, the shortcuts). The stem is int8 too,
over the 4x4 space-to-depth input (48 channels). The SE modules, the blur
pool and the shortcut's average pool stay float, as in the JAX function;
the SE runs in float32 and rounds once to the compute dtype.

Every int8 convolution runs through ``ops.quant.quantized_conv_bn``: Q1
(``csrc/qconv_bn.cu``) on CUDA tensors, on the path ``qconv_path`` picks
from the shapes (TResNet-L's widths 76 and 152 have Cin % 16 != 0, so
their convolutions take Q1's ``mma.sync`` loop; 48, 304, 608 and the
wider ones the wgmma paths), and the exact plain version on CPU tensors.
Activations are NHWC, as in the JAX function.

Use::

    qp = quantize_tresnet(float_tresnet)             # dynamic scales
    qp = calibrate_tresnet(qp, frames, layers)       # static scales
    out = quantized_tresnet_apply(qp, frames, layers)
    qp = make_int8_tresnet("tresnet_l", float_tresnet, frames)
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.fused_norm import blur_pool, space_to_depth
from ..ops.quant import quantized_conv_bn
from .quantized import QConv, _qconv
from .tresnet import VARIANTS, TResNet, avg_pool_2x2

STEM_SLOPE = 1e-2
BLOCK_SLOPE = 1e-3
PAD1 = ((1, 1), (1, 1))
PAD0 = ((0, 0), (0, 0))


class FloatDense(nn.Module):
    """An SE ``Dense`` carried through in float32: buffers ``kernel`` (in,
    out) and ``bias``."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("kernel", kernel)
        self.register_buffer("bias", bias)

    def forward(self, s):
        return s @ self.kernel + self.bias


class QuantizedTResNet(nn.Module):
    """Int8 TResNet backbone: NHWC frames -> ``{"stages", "pooled"}``.

    Children mirror the JAX ``quantize_tresnet`` tree: ``stem`` and
    ``layer{s}_{b}`` blocks holding ``conv1``..``conv3``, ``downsample``
    (``QConv``) and ``se`` (``fc1``, ``fc2``: ``FloatDense``)."""

    def __init__(self, layers: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.layers, self.dtype = tuple(layers), dtype

    def forward(self, x: torch.Tensor) -> Dict[str, object]:
        return quantized_tresnet_apply(self, x, self.layers, self.dtype)


def quantize_tresnet(backbone: TResNet,
                     dtype: Optional[torch.dtype] = None
                     ) -> QuantizedTResNet:
    """Fold every (conv, ABN) pair of a float TResNet into int8 form; the
    SE ``Dense`` parameters are carried through in float32. The result is
    on the backbone's device, computing in ``dtype`` (default the
    backbone's)."""
    qp = QuantizedTResNet([len(n) for n in backbone.stage_names],
                          dtype or backbone.dtype)
    with torch.no_grad():
        qp.stem = _qconv(backbone.stem_conv, backbone.stem_abn.bn)
        for names in backbone.stage_names:
            for name in names:
                blk = getattr(backbone, name)
                q = nn.Module()
                for i in (1, 2, 3):
                    if hasattr(blk, f"conv{i}"):
                        setattr(q, f"conv{i}", _qconv(
                            getattr(blk, f"conv{i}"),
                            getattr(blk, f"abn{i}").bn))
                if blk.has_downsample:
                    q.downsample = _qconv(blk.downsample,
                                          blk.downsample_abn.bn)
                if blk.use_se:
                    q.se = nn.Module()
                    for fc in ("fc1", "fc2"):
                        d = getattr(blk.se, fc)
                        setattr(q.se, fc, FloatDense(
                            d.kernel.detach().float().clone(),
                            d.bias.detach().float().clone()))
                qp.add_module(name, q)
    return qp


def _se(x: torch.Tensor, se: nn.Module, dtype) -> torch.Tensor:
    xf = x.float()
    s = torch.relu(se.fc1(xf.mean(dim=(1, 2))))
    s = torch.sigmoid(se.fc2(s))
    return (xf * s[:, None, None, :]).to(dtype)


def _downsample(x, q, stride: int, dtype, record):
    if stride == 2:
        x = avg_pool_2x2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return quantized_conv_bn(x, q.downsample.qw, padding=PAD0, dtype=dtype,
                             record=record)


def _residual(h, x, q, stride: int, dtype, record):
    identity = (_downsample(x, q, stride, dtype, record)
                if hasattr(q, "downsample") else x)
    return torch.relu(h + identity)


def _basic(x, q, stride: int, dtype, record):
    h = quantized_conv_bn(x, q.conv1.qw, padding=PAD1,
                          leaky_slope=BLOCK_SLOPE, dtype=dtype,
                          record=record)
    if stride == 2:  # anti-alias after conv1
        h = blur_pool(h)
    h = quantized_conv_bn(h, q.conv2.qw, padding=PAD1, dtype=dtype,
                          record=record)
    if hasattr(q, "se"):
        h = _se(h, q.se, dtype)
    return _residual(h, x, q, stride, dtype, record)


def _bottleneck(x, q, stride: int, dtype, record):
    h = quantized_conv_bn(x, q.conv1.qw, padding=PAD0,
                          leaky_slope=BLOCK_SLOPE, dtype=dtype,
                          record=record)
    h = quantized_conv_bn(h, q.conv2.qw, padding=PAD1,
                          leaky_slope=BLOCK_SLOPE, dtype=dtype,
                          record=record)
    if stride == 2:  # anti-alias after conv2
        h = blur_pool(h)
    if hasattr(q, "se"):
        h = _se(h, q.se, dtype)
    h = quantized_conv_bn(h, q.conv3.qw, padding=PAD0, dtype=dtype,
                          record=record)
    return _residual(h, x, q, stride, dtype, record)


def quantized_tresnet_apply(qp: QuantizedTResNet, x: torch.Tensor,
                            layers: Sequence[int],
                            dtype: torch.dtype = torch.bfloat16,
                            record: Optional[list] = None
                            ) -> Dict[str, object]:
    """The TResNet forward with int8 convolutions; x NHWC."""
    x = space_to_depth(x.to(dtype), 4)
    x = quantized_conv_bn(x, qp.stem.qw, padding=PAD1,
                          leaky_slope=STEM_SLOPE, dtype=dtype, record=record)
    stages = []
    for si, depth in enumerate(layers):
        blk = _basic if si < 2 else _bottleneck
        for bi in range(depth):
            stride = 2 if si > 0 and bi == 0 else 1
            x = blk(x, getattr(qp, f"layer{si + 1}_{bi}"), stride, dtype,
                    record)
        stages.append(x)
    return {"stages": stages, "pooled": x.mean(dim=(1, 2))}


def _conv_call_order(qp: QuantizedTResNet, layers: Sequence[int]
                     ) -> List[QConv]:
    """The int8 convs in the order ``quantized_tresnet_apply`` runs them."""
    order = [qp.stem]
    for si, depth in enumerate(layers):
        for bi in range(depth):
            q = getattr(qp, f"layer{si + 1}_{bi}")
            order.extend(getattr(q, f"conv{i}") for i in (1, 2, 3)
                         if hasattr(q, f"conv{i}"))
            if hasattr(q, "downsample"):
                order.append(q.downsample)
    return order


def calibrate_tresnet(qp: QuantizedTResNet, x: torch.Tensor,
                      layers: Sequence[int],
                      dtype: torch.dtype = torch.bfloat16,
                      margin: float = 1.0) -> QuantizedTResNet:
    """Bake static per-conv activation scales from a calibration batch (as
    ``models.quantized.calibrate_resnet``): a copy of ``qp`` whose convs
    carry ``act_scale`` = the recorded dynamic scale x ``margin``."""
    record: list = []
    with torch.no_grad():
        quantized_tresnet_apply(qp, x, layers, dtype=dtype, record=record)
    new = copy.deepcopy(qp)
    order = _conv_call_order(new, layers)
    assert len(order) == len(record), (len(order), len(record))
    for q, s in zip(order, record):
        q.act_scale = torch.tensor(s * margin, dtype=torch.float32,
                                   device=q.mult.device)
    return new


def make_int8_tresnet(name: str, backbone: TResNet,
                      calibrate_frames: Optional[torch.Tensor] = None,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> QuantizedTResNet:
    """The int8 twin of the float ``backbone`` of variant ``name``, with
    static scales from ``calibrate_frames`` (normalised NHWC frames) when
    given, else dynamic ones; call it on frames for ``{"pooled",
    "stages"}``."""
    qp = quantize_tresnet(backbone, dtype)
    if calibrate_frames is not None:
        frames = torch.as_tensor(calibrate_frames).to(qp.stem.mult.device,
                                                      dtype)
        qp = calibrate_tresnet(qp, frames, VARIANTS[name]["layers"], dtype)
    return qp
