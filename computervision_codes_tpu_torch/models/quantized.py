"""Int8 post-training-quantized ResNet student (inference/serving path).

Counterpart of ``models/quantized.py`` in the JAX package. A float ResNet
(``models.resnet``) is converted once into a ``QuantizedResNet``: every
(conv, BatchNorm) pair becomes per-channel int8 weights with the BN folded
into the dequant affine (``ops.quant``), and the 7x7 stem stays a
BN-folded float conv (``float_stem=True``, the default). The module holds
its weights as buffers in the form the kernels take (int8 ``w_q`` as
(Cout, kh, kw, Cin), float32 ``mult``, ``bias`` and ``act_scale``), so a
forward casts no weight.

Use::

    qp = quantize_resnet(float_backbone)               # dynamic scales
    qp = calibrate_resnet(qp, frames, stage_sizes)     # static scales
    out = quantized_resnet_apply(qp, frames, stage_sizes, block="basic")
    model = make_int8_e2e(recognizer, calibrate_clips)  # int8 backbone + TCN

Every int8 convolution runs through ``ops.quant.quantized_conv_bn``: the
CUDA kernel on CUDA tensors, the exact plain version on CPU tensors.
Activations are NHWC throughout, as in the JAX function.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import fold_bn, quantize_weight, quantized_conv_bn
from ..ops.stem_pool import stem_pool_fused
from .resnet import VARIANTS, BN_EPS, BasicBlock, ResNet, _s2d_conv1


class QConv(nn.Module):
    """One folded conv: buffers ``w_q``, ``mult``, ``bias`` and
    ``act_scale`` (None until calibrated), or ``w`` (HWIO float32) and
    ``bias`` for a BN-folded float conv."""

    def __init__(self, qw: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, value in qw.items():
            self.register_buffer(name, value)
        if "w_q" in qw and "act_scale" not in qw:
            self.register_buffer("act_scale", None)

    @property
    def qw(self) -> Dict[str, torch.Tensor]:
        """The dict ``quantized_conv_bn`` takes."""
        return {k: v for k, v in self._buffers.items() if v is not None}


def _bn_dict(bn) -> Dict[str, torch.Tensor]:
    return {"scale": bn.weight, "bias": bn.bias, "mean": bn.running_mean,
            "var": bn.running_var}


def _qconv(conv, bn, quant: bool = True) -> QConv:
    kernel = conv.weight.detach().float().permute(2, 3, 1, 0)  # HWIO
    bnd = {k: v.detach().float() for k, v in _bn_dict(bn).items()}
    if not quant:
        # BN folded into float weights (the stem)
        mult, bias = fold_bn(torch.ones_like(bnd["scale"]), bnd, BN_EPS)
        return QConv({"w": (kernel * mult).contiguous(), "bias": bias})
    w_q, s_w = quantize_weight(kernel)
    mult, bias = fold_bn(s_w, bnd, BN_EPS)
    return QConv({"w_q": w_q.permute(3, 0, 1, 2).contiguous(),
                  "mult": mult, "bias": bias})


class QuantizedResNet(nn.Module):
    """Int8 ResNet backbone: NHWC frames -> ``{"stages", "pooled"}``.

    Children mirror the JAX ``quantize_resnet`` tree: ``conv1`` and
    ``layer{s}_{b}`` blocks holding ``conv1``..``conv3`` and
    ``downsample``. The attributes ``s2d_stem`` and ``fused_stem`` (both
    False until set, as ``make_int8_e2e`` does) choose the stem plan of
    ``forward``.
    """

    def __init__(self, stage_sizes: Sequence[int], block: str,
                 num_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stage_sizes, self.block = tuple(stage_sizes), block
        self.num_channels, self.dtype = num_channels, dtype
        self.s2d_stem = self.fused_stem = False

    def forward(self, x: torch.Tensor) -> Dict[str, object]:
        return quantized_resnet_apply(
            self, x, self.stage_sizes, block=self.block, dtype=self.dtype,
            s2d_stem=self.s2d_stem, fused_stem=self.fused_stem)


def quantize_resnet(backbone: ResNet, float_stem: bool = True
                    ) -> QuantizedResNet:
    """Fold every (conv, bn) pair of a float ResNet into int8 form.

    Works for BasicBlock and Bottleneck backbones. ``float_stem`` keeps the
    7x7 stem as a BN-folded float conv. The result is on the backbone's
    device, with its compute dtype.
    """
    block = "basic" if issubclass(
        type(getattr(backbone, backbone.stage_names[0][0])), BasicBlock) \
        else "bottleneck"
    qp = QuantizedResNet([len(n) for n in backbone.stage_names], block,
                         backbone.num_channels, backbone.dtype)
    with torch.no_grad():
        qp.conv1 = _qconv(backbone.conv1, backbone.bn1, quant=not float_stem)
        for names in backbone.stage_names:
            for name in names:
                blk = getattr(backbone, name)
                q = nn.Module()
                for i in (1, 2, 3):
                    if hasattr(blk, f"conv{i}"):
                        setattr(q, f"conv{i}", _qconv(
                            getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}")))
                if blk.has_downsample:
                    q.downsample = _qconv(blk.downsample_conv,
                                          blk.downsample_bn)
                qp.add_module(name, q)
    return qp


def _basic_block(x, q, stride: int, dtype, record):
    out = quantized_conv_bn(x, q.conv1.qw, stride=stride,
                            padding=((1, 1), (1, 1)), relu=True, dtype=dtype,
                            record=record)
    out = quantized_conv_bn(out, q.conv2.qw, padding=((1, 1), (1, 1)),
                            dtype=dtype, record=record)
    if hasattr(q, "downsample"):
        identity = quantized_conv_bn(x, q.downsample.qw, stride=stride,
                                     padding=((0, 0), (0, 0)), dtype=dtype,
                                     record=record)
    else:
        identity = x
    return torch.relu(out + identity)


def _bottleneck_block(x, q, stride: int, dtype, record):
    out = quantized_conv_bn(x, q.conv1.qw, padding=((0, 0), (0, 0)),
                            relu=True, dtype=dtype, record=record)
    out = quantized_conv_bn(out, q.conv2.qw, stride=stride,
                            padding=((1, 1), (1, 1)), relu=True, dtype=dtype,
                            record=record)
    out = quantized_conv_bn(out, q.conv3.qw, padding=((0, 0), (0, 0)),
                            dtype=dtype, record=record)
    if hasattr(q, "downsample"):
        identity = quantized_conv_bn(x, q.downsample.qw, stride=stride,
                                     padding=((0, 0), (0, 0)), dtype=dtype,
                                     record=record)
    else:
        identity = x
    return torch.relu(out + identity)


def _max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 / pad 1 max-pool (padding -inf, as flax's), NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def quantized_resnet_apply(qp: QuantizedResNet, x: torch.Tensor,
                           stage_sizes: Sequence[int], block: str = "basic",
                           dtype: torch.dtype = torch.bfloat16,
                           record: Optional[list] = None,
                           s2d_stem: bool = False,
                           fused_stem: bool = False) -> Dict[str, object]:
    """Mirror of the float ResNet forward with int8 convs; x NHWC.

    Stem plans (float-stem config only, as in JAX): ``fused_stem`` runs
    conv1 + bias + ReLU + max-pool as one kernel (``ops.stem_pool``) when
    H, W % 4 == 0; else ``s2d_stem`` runs conv1 through the space-to-depth
    reparametrisation when H, W are even. ``fused_stem`` wins when both are
    set.
    """
    blk = _basic_block if block == "basic" else _bottleneck_block
    stem = qp.conv1.qw
    h, w = x.shape[1], x.shape[2]
    if fused_stem and "w" in stem and h % 4 == 0 and w % 4 == 0:
        x = stem_pool_fused(x.to(dtype).contiguous(), stem["w"].to(dtype),
                            stem["bias"])
    else:
        if s2d_stem and "w" in stem and h % 2 == 0 and w % 2 == 0:
            y = _s2d_conv1(x.to(dtype).permute(0, 3, 1, 2),
                           stem["w"].to(dtype).permute(3, 2, 0, 1))
            y = torch.relu(y + stem["bias"].to(dtype).view(1, -1, 1, 1))
            x = y.permute(0, 2, 3, 1)
        else:
            x = quantized_conv_bn(x.to(dtype), stem, stride=2,
                                  padding=((3, 3), (3, 3)), relu=True,
                                  dtype=dtype, record=record)
        x = _max_pool_nhwc(x)
    stages = []
    for si, num_blocks in enumerate(stage_sizes):
        for bi in range(num_blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            x = blk(x, getattr(qp, f"layer{si + 1}_{bi}"), stride, dtype,
                    record)
        stages.append(x)
    return {"stages": stages, "pooled": x.mean(dim=(1, 2))}


def _conv_call_order(qp: QuantizedResNet, stage_sizes: Sequence[int],
                     block: str) -> List[QConv]:
    """The int8 convs in the order ``quantized_resnet_apply`` runs them
    (a float stem records no activation scale)."""
    order = [qp.conv1] if "w_q" in qp.conv1.qw else []
    for si, num_blocks in enumerate(stage_sizes):
        for bi in range(num_blocks):
            q = getattr(qp, f"layer{si + 1}_{bi}")
            order.extend([q.conv1, q.conv2])
            if block != "basic":
                order.append(q.conv3)
            if hasattr(q, "downsample"):
                order.append(q.downsample)
    return order


def calibrate_resnet(qp: QuantizedResNet, x: torch.Tensor,
                     stage_sizes: Sequence[int], block: str = "basic",
                     dtype: torch.dtype = torch.bfloat16,
                     margin: float = 1.0) -> QuantizedResNet:
    """Bake static per-layer activation scales from a calibration batch.

    Runs one eager forward (standard stem) recording each int8 conv's
    dynamic absmax scale, then returns a copy of ``qp`` whose convs carry
    ``act_scale`` = recorded scale x ``margin`` (float32). ``qp`` itself is
    left as it was.
    """
    record: list = []
    with torch.no_grad():
        quantized_resnet_apply(qp, x, stage_sizes, block=block, dtype=dtype,
                               record=record)
    new = copy.deepcopy(qp)
    order = _conv_call_order(new, stage_sizes, block)
    assert len(order) == len(record), (len(order), len(record))
    for q, s in zip(order, record):
        q.act_scale = torch.tensor(s * margin, dtype=torch.float32,
                                   device=q.mult.device)
    return new


class Int8Recognizer(nn.Module):
    """Int8 variant of ``EndToEndRecognizer``: the quantized backbone over
    frames, then the recognizer's own TCN in its compute dtype."""

    def __init__(self, backbone: QuantizedResNet, tcn: nn.Module):
        super().__init__()
        self.backbone, self.tcn = backbone, tcn

    def forward(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, t, h, w, c = clips.shape
        feats = self.backbone(clips.reshape(b * t, h, w, c))["pooled"]
        seq = feats.reshape(b, t, -1)
        out = self.tcn(seq)
        return {"ivt": out["ivt"][0], "i": out["i"][0], "v": out["v"][0],
                "t": out["t"][0], "features": seq}


def make_int8_e2e(model, calibrate_clips: Optional[torch.Tensor] = None,
                  s2d_stem: bool = False, fused_stem: bool = False
                  ) -> Int8Recognizer:
    """Int8 backbone + the float TCN of ``model`` (an EndToEndRecognizer
    holding the trained weights).

    ``calibrate_clips`` (B, T, H, W, 3), normalised: when given, one eager
    forward bakes static activation scales (``calibrate_resnet``, standard
    stem); without them every int8 conv uses its dynamic scale. The TCN is
    ``model.tcn`` itself (shared, not copied).
    """
    sizes, block_cls = VARIANTS[model.network]
    block = "basic" if block_cls is BasicBlock else "bottleneck"
    qp = quantize_resnet(model.backbone)
    if calibrate_clips is not None:
        b, t, h, w, c = calibrate_clips.shape
        qp = calibrate_resnet(qp, calibrate_clips.reshape(b * t, h, w, c),
                              sizes, block=block, dtype=qp.dtype)
    qp.s2d_stem, qp.fused_stem = s2d_stem, fused_stem
    return Int8Recognizer(qp, model.tcn)
