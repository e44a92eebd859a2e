"""Carry the JAX package's weights into the port's modules.

``load_jax_variables(module, variables)`` takes the variables of the JAX
counterpart of ``module`` (what its ``init`` returns: a nested mapping of
collections ``params``, ``batch_stats`` and ``frozen``, with numpy or JAX
arrays at the leaves) and copies them in, walking the port's module tree by
the flax names its children carry:

* ``conv*/kernel`` (kh, kw, Cin, Cout) HWIO -> conv weight OIHW (TResNet's
  ``stem_conv``, ``conv1-3`` and ``downsample`` too);
* ``bn*``: ``params/{scale,bias}`` + ``batch_stats/{mean,var}`` -> BatchNorm
  ``weight, bias, running_mean, running_var`` (TResNet's ABN holds its
  BatchNorm as ``<abn>/bn``); a frozen BN reads all four from the
  ``frozen`` collection;
* a conv with a bias (Swin's ``patch_embed``) reads ``bias`` too;
* 1x1 ``nn.Conv`` over time (``pg_conv_in``, ``latlayer1``, ``head_*``):
  ``kernel`` (1, Cin, Cout) -> weight (Cout, Cin), plus ``bias``;
* every other parameter is read by its own name and keeps the JAX layout:
  ``Dense`` ``kernel`` (in, out) and ``bias``, any other 1-D ``nn.Conv``
  (MS-TCT's k3 ``merge*/proj`` and depthwise ``lrb/tc``, ``TemporalConv``)
  ``kernel`` (k, Cin / groups, Cout) and ``bias``, ``LayerNorm`` ``scale`` and
  ``bias``, the dilated layers' ``w_taps, b1, w2, b2``, and raw params
  such as ``relative_position_bias_table``, ``query_embed_*`` and
  ``fc_*/{W,b}`` (the ``Mlp`` children are named ``Dense_0``/``Dense_1``,
  as flax names them; TResNet's SE ``fc1``/``fc2`` are ``Dense``).

* TERL's queue (``models.moco.MoCoQueue``) reads its buffers ``feats``,
  ``l_ivt``, ``l_i``, ``l_v``, ``l_t``, ``ptr`` and ``proto_{i,v,t}`` from
  the ``queue`` collection, in their own dtypes (the labels and the pointer
  int32): ``load_jax_variables(queue, {"queue": tree["queue"]})`` with the
  ``queue`` of a JAX ``TERLTrainState``, whose ``params`` and
  ``key_params`` load into the query module and its key copy.

Every leaf of ``variables`` must be used and every parameter filled:
a missing or extra key raises ``KeyError``, a shape mismatch ``ValueError``.

``jax_variables(module)`` goes the other way: the variables of the JAX
counterpart, as nested dicts of float32 numpy arrays in the JAX layouts
above, so that ``load_jax_variables`` of the result fills an equal module
and a flax checkpoint of the port's weights restores in JAX.

The torch-layout converters are the port's copies of the JAX package's
(``models/convert.py`` there): ``load_torch_state_dict`` reads a ``.pth``
(``torch.load(..., weights_only=True)``, ``module.`` prefixes stripped), and
``convert_torchvision_resnet``, ``convert_swin``, ``convert_tresnet`` and
``convert_cvt`` map a torchvision / microsoft / TResNet / CvT (microsoft's
or HF transformers' ``CvtModel`` layout) state dict onto the flax-named
numpy tree that ``load_jax_variables`` takes (conv OIHW -> HWIO, linear
(out, in) -> (in, out), BatchNorm -> ``params`` scale/bias +
``batch_stats`` mean/var, or all four in ``frozen``).

``load_jax_quantized(qmodule, q_backbone)`` does the same for a tree that
the JAX ``quantize_resnet`` / ``calibrate_resnet`` (or ``quantize_tresnet``
/ ``calibrate_tresnet``, whose SE ``Dense`` layers stay float) made: int8
``w_q`` goes from HWIO to the kernel's (Cout, kh, kw, Cin), ``w`` (a float
stem) stays HWIO, and ``mult``, ``bias`` and ``act_scale`` come across as
they are (a conv without ``act_scale`` in the tree goes back to dynamic
scales).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from .moco import QUEUE_FIELDS, MoCoQueue
from .quant_tresnet import FloatDense
from .quantized import QConv
from .resnet import BatchNorm, Conv2d, FrozenBatchNorm
from .tcn import Conv1x1

_COLLECTIONS = ("params", "batch_stats", "frozen", "queue")
Path = Tuple[str, ...]


def _leaves(tree, prefix: Path = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),)


class _Loader:
    def __init__(self, variables):
        extra = set(variables) - set(_COLLECTIONS)
        if extra:
            raise KeyError(f"unknown variable collections {sorted(extra)}")
        self.variables = variables
        self.used: Set[Path] = set()

    def get(self, coll: str, path: Path, dtype=np.float32) -> np.ndarray:
        node = self.variables.get(coll, {})
        for i, k in enumerate(path):
            if not isinstance(node, Mapping) or k not in node:
                raise KeyError(f"missing {coll}/{'/'.join(path[:i + 1])}")
            node = node[k]
        self.used.add((coll,) + path)
        return np.asarray(node, dtype=dtype)

    def put(self, dst: torch.Tensor, value: np.ndarray, where: str) -> None:
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"{where}: shape {value.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(value)))  # writable copy

    def load(self, module: nn.Module, path: Path) -> None:
        def p(*keys: str) -> Path:
            return path + keys

        name = "/".join(path)
        if isinstance(module, Conv2d):
            kernel = self.get("params", p("kernel"))  # HWIO
            self.put(module.weight, kernel.transpose(3, 2, 0, 1), name)
            if module.bias is not None:
                self.put(module.bias, self.get("params", p("bias")), name)
        elif isinstance(module, Conv1x1):
            kernel = self.get("params", p("kernel"))  # (1, Cin, Cout)
            if kernel.ndim != 3 or kernel.shape[0] != 1:
                raise ValueError(f"{name}: kernel {kernel.shape} is not a "
                                 f"(1, Cin, Cout) 1x1 conv")
            self.put(module.weight, kernel[0].T, name)
            self.put(module.bias, self.get("params", p("bias")), name)
        elif isinstance(module, FrozenBatchNorm):
            for dst, key in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
                self.put(getattr(module, dst), self.get("frozen", p(key)),
                         name)
        elif isinstance(module, BatchNorm):
            for dst, coll, key in (("weight", "params", "scale"),
                                   ("bias", "params", "bias"),
                                   ("running_mean", "batch_stats", "mean"),
                                   ("running_var", "batch_stats", "var")):
                self.put(getattr(module, dst), self.get(coll, p(key)), name)
        elif isinstance(module, MoCoQueue):
            for key in QUEUE_FIELDS:
                dst = getattr(module, key)
                self.put(dst, self.get("queue", p(key),
                                       np.dtype(str(dst.dtype)[6:])),
                         f"queue/{key}")
        else:
            for key, param in module.named_parameters(recurse=False):
                self.put(param, self.get("params", p(key)), f"{name}/{key}")
            for child_name, child in module.named_children():
                self.load(child, p(child_name))


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill ``module`` in place from its JAX counterpart's variables."""
    loader = _Loader(variables)
    with torch.no_grad():
        loader.load(module, ())
    present = {(c,) + leaf for c in _COLLECTIONS
               for leaf in _leaves(variables.get(c, {}))}
    extra = sorted("/".join(k) for k in present - loader.used)
    if extra:
        raise KeyError(f"JAX variables not used by {type(module).__name__}: "
                       f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    return module


class _Exporter:
    def __init__(self):
        self.variables = {}

    def put(self, coll: str, path: Path, value: torch.Tensor) -> None:
        node = self.variables.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if value.is_floating_point():
            value = value.float()
        node[path[-1]] = value.detach().cpu().numpy().copy()

    def export(self, module: nn.Module, path: Path) -> None:
        def p(*keys: str) -> Path:
            return path + keys

        if isinstance(module, Conv2d):
            self.put("params", p("kernel"), module.weight.permute(2, 3, 1, 0))
            if module.bias is not None:
                self.put("params", p("bias"), module.bias)
        elif isinstance(module, Conv1x1):
            self.put("params", p("kernel"), module.weight.T[None])
            self.put("params", p("bias"), module.bias)
        elif isinstance(module, MoCoQueue):
            for key in QUEUE_FIELDS:
                self.put("queue", p(key), getattr(module, key))
        elif isinstance(module, BatchNorm):
            frozen = isinstance(module, FrozenBatchNorm)
            for src, coll, key in (("weight", "params", "scale"),
                                   ("bias", "params", "bias"),
                                   ("running_mean", "batch_stats", "mean"),
                                   ("running_var", "batch_stats", "var")):
                self.put("frozen" if frozen else coll, p(key),
                         getattr(module, src))
        else:
            for key, param in module.named_parameters(recurse=False):
                self.put("params", p(key), param)
            for child_name, child in module.named_children():
                self.export(child, p(child_name))


def jax_variables(module: nn.Module):
    """The variables of ``module``'s JAX counterpart (the inverse of
    ``load_jax_variables``): ``{"params": ...}``, with ``batch_stats`` and
    ``frozen`` where the module has such BatchNorms (a ``MoCoQueue``:
    ``{"queue": ...}``, its labels and pointer int32)."""
    exporter = _Exporter()
    exporter.export(module, ())
    return exporter.variables


def jax_quantized(qmodule: nn.Module):
    """The JAX quantized tree of a ``QuantizedResNet`` or
    ``QuantizedTResNet`` (the inverse of ``load_jax_quantized``): each
    conv's ``w_q`` (HWIO int8), ``mult``, ``bias`` and ``act_scale`` (when
    calibrated), or a float conv's ``w`` and ``bias``, as numpy."""
    tree: Dict = {}
    for name, conv in qmodule.named_modules():
        if not isinstance(conv, (QConv, FloatDense)):
            continue
        node = tree
        for k in name.split("."):
            node = node.setdefault(k, {})
        for key, value in conv.named_buffers(recurse=False):
            if value is None:
                continue
            a = value.detach().cpu()
            if key == "w_q":
                a = a.permute(1, 2, 3, 0)  # OHWI -> HWIO
            node[key] = a.numpy().copy()
    return tree


def load_jax_quantized(qmodule: nn.Module, q_backbone) -> nn.Module:
    """Fill a ``QuantizedResNet`` or ``QuantizedTResNet`` in place from a
    JAX quantized tree of the same architecture and stem kind (a
    TResNet's float SE ``kernel`` and ``bias`` too)."""
    convs = {name: m for name, m in qmodule.named_modules()
             if isinstance(m, (QConv, FloatDense))}
    nodes = {}

    def walk(tree, prefix):
        if any(not isinstance(v, Mapping) for v in tree.values()):
            nodes[".".join(prefix)] = tree
            return
        for k, v in tree.items():
            walk(v, prefix + (str(k),))

    walk(q_backbone, ())
    if set(nodes) != set(convs):
        odd = sorted(set(nodes) ^ set(convs))
        raise KeyError(f"convs {odd[:8]} are not in both the quantized tree "
                       f"and the module")
    with torch.no_grad():
        for name, conv in convs.items():
            node = {k: np.asarray(v) for k, v in nodes[name].items()}
            if isinstance(conv, FloatDense):
                for key in ("kernel", "bias"):
                    conv.get_buffer(key).copy_(torch.from_numpy(
                        np.array(node.pop(key), np.float32)))
                if node:
                    raise KeyError(f"{name}: unknown keys {sorted(node)}")
                continue
            kinds = ("w" in node, "w" in conv.qw)
            if kinds[0] != kinds[1]:
                raise ValueError(f"{name}: float stem in "
                                 f"{'the tree' if kinds[0] else 'the module'}"
                                 f" only")
            extra = set(node) - {"w", "w_q", "mult", "bias", "act_scale"}
            if extra:
                raise KeyError(f"{name}: unknown keys {sorted(extra)}")
            for key, value in node.items():
                if key == "act_scale":
                    conv.act_scale = torch.tensor(np.float32(value),
                                                  device=conv.bias.device)
                    continue
                if key == "w_q":
                    value = value.transpose(3, 0, 1, 2)  # HWIO -> OHWI
                want = getattr(conv, key)
                if tuple(want.shape) != value.shape:
                    raise ValueError(f"{name}/{key}: shape {value.shape} "
                                     f"does not fit {tuple(want.shape)}")
                want.copy_(torch.from_numpy(np.array(value)).to(want.dtype))
            if "w_q" in node and "act_scale" not in node:
                conv.act_scale = None
    return qmodule


# ---------------------------------------------------------------------------
# torch-layout checkpoints (torchvision, microsoft Swin, TResNet) -> the
# flax-named trees above


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.pth`` as numpy arrays: the file's
    ``state_dict`` or ``model`` entry where it has one, ``module.``
    prefixes stripped. Loaded with ``weights_only=True`` (no code runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"],
                                                             dict):
        sd = sd["model"]
    return {k.removeprefix("module."): v.detach().cpu().numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def convert_torchvision_resnet(sd: Dict[str, np.ndarray], stage_sizes,
                               frozen_bn: bool = False) -> Dict:
    """torchvision resnet18/34/50/101 state dict -> ``{"params",
    "batch_stats"}`` (``{"params", "frozen"}`` with ``frozen_bn``)."""
    params: Dict = {}
    stats: Dict = {}
    frozen: Dict = {}

    def put_bn(prefix: str, *path: str):
        p, s = _bn(sd, prefix)
        if frozen_bn:
            dst = frozen
            for key in path[:-1]:
                dst = dst.setdefault(key, {})
            dst[path[-1]] = {**p, **s}
        else:
            for tree, leaf in ((params, p), (stats, s)):
                dst = tree
                for key in path[:-1]:
                    dst = dst.setdefault(key, {})
                dst[path[-1]] = leaf

    params["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    put_bn("bn1", "bn1")
    bottleneck = any(k.startswith("layer1.0.conv3") for k in sd)
    n_convs = 3 if bottleneck else 2
    for si, blocks in enumerate(stage_sizes):
        for bi in range(blocks):
            t = f"layer{si + 1}.{bi}"
            name = f"layer{si + 1}_{bi}"
            block: Dict = {
                f"conv{ci}": {"kernel": _conv(sd[f"{t}.conv{ci}.weight"])}
                for ci in range(1, n_convs + 1)
            }
            params[name] = block
            for ci in range(1, n_convs + 1):
                put_bn(f"{t}.bn{ci}", name, f"bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                block["downsample_conv"] = {
                    "kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                put_bn(f"{t}.downsample.1", name, "downsample_bn")
    out = {"params": params}
    if frozen_bn:
        out["frozen"] = frozen
    else:
        out["batch_stats"] = stats
    return out


def convert_tresnet(sd: Dict[str, np.ndarray], layers) -> Dict:
    """Official TResNet checkpoint (``body.conv1``, ``body.layer{1-4}.{b}.
    {conv1,conv2,conv3,se,downsample}``) -> ``{"params", "batch_stats"}``
    for ``models.tresnet.TResNet``. Each conv2d_ABN pair maps to (conv
    kernel, ``<abn>/bn``); an anti-aliased block's conv sits one
    Sequential deeper (``conv1.0.0``); the SE 1x1 convs become Dense."""
    params: Dict = {}
    stats: Dict = {}

    def put_abn(prefix: str, *path):
        p, s = _bn(sd, prefix)
        for tree, leaf in ((params, p), (stats, s)):
            dst = tree
            for key in path:
                dst = dst.setdefault(key, {})
            dst["bn"] = leaf

    def conv_abn(src: str, dst_block: Dict, conv_name: str, abn_path):
        if f"{src}.0.0.weight" in sd:  # Sequential(conv2d_ABN, blur) form
            src = f"{src}.0"
        dst_block[conv_name] = {"kernel": _conv(sd[f"{src}.0.weight"])}
        put_abn(f"{src}.1", *abn_path)

    def se_dense(w: np.ndarray) -> np.ndarray:
        return _dense(w[:, :, 0, 0])  # 1x1 conv acting on pooled vector

    params["stem_conv"] = {"kernel": _conv(sd["body.conv1.0.weight"])}
    put_abn("body.conv1.1", "stem_abn")
    for si, depth in enumerate(layers):
        bottleneck = si >= 2
        for bi in range(depth):
            t = f"body.layer{si + 1}.{bi}"
            name = f"layer{si + 1}_{bi}"
            block: Dict = {}
            params[name] = block
            conv_abn(f"{t}.conv1", block, "conv1", (name, "abn1"))
            conv_abn(f"{t}.conv2", block, "conv2", (name, "abn2"))
            if bottleneck:
                conv_abn(f"{t}.conv3", block, "conv3", (name, "abn3"))
            if f"{t}.se.fc1.weight" in sd:
                block["se"] = {
                    "fc1": {"kernel": se_dense(sd[f"{t}.se.fc1.weight"]),
                            "bias": sd[f"{t}.se.fc1.bias"]},
                    "fc2": {"kernel": se_dense(sd[f"{t}.se.fc2.weight"]),
                            "bias": sd[f"{t}.se.fc2.bias"]},
                }
            # downsample: Sequential([AvgPool,] conv2d_ABN); the conv_abn
            # index is 1 when the pool is present, 0 otherwise
            for di in (1, 0):
                if f"{t}.downsample.{di}.0.weight" in sd:
                    block["downsample"] = {
                        "kernel": _conv(sd[f"{t}.downsample.{di}.0.weight"])}
                    put_abn(f"{t}.downsample.{di}.1", name, "downsample_abn")
                    break
    return {"params": params, "batch_stats": stats}


_HF_CVT_RENAMES = (
    (".embedding.convolution_embeddings.projection.", ".patch_embed.proj."),
    (".embedding.convolution_embeddings.normalization.", ".patch_embed.norm."),
    (".attention.attention.convolution_projection_query.convolution_projection.convolution.",
     ".attn.conv_proj_q.conv."),
    (".attention.attention.convolution_projection_key.convolution_projection.convolution.",
     ".attn.conv_proj_k.conv."),
    (".attention.attention.convolution_projection_value.convolution_projection.convolution.",
     ".attn.conv_proj_v.conv."),
    (".attention.attention.convolution_projection_query.convolution_projection.normalization.",
     ".attn.conv_proj_q.bn."),
    (".attention.attention.convolution_projection_key.convolution_projection.normalization.",
     ".attn.conv_proj_k.bn."),
    (".attention.attention.convolution_projection_value.convolution_projection.normalization.",
     ".attn.conv_proj_v.bn."),
    (".attention.attention.projection_query.", ".attn.proj_q."),
    (".attention.attention.projection_key.", ".attn.proj_k."),
    (".attention.attention.projection_value.", ".attn.proj_v."),
    (".attention.output.dense.", ".attn.proj."),
    (".intermediate.dense.", ".mlp.fc1."),
    (".output.dense.", ".mlp.fc2."),
    (".layernorm_before.", ".norm1."),
    (".layernorm_after.", ".norm2."),
)


def _cvt_canonical(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize an HF CvtModel/CvtForImageClassification state_dict onto
    the official microsoft layout the reference loads
    (Spatial_transformer/models/cls_cvt — keys stage{i}.blocks.{j}.*).
    Official-layout dicts pass through unchanged."""
    if not any(".encoder.stages." in k or k.startswith("encoder.stages.")
               for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("cvt.")
        k = k.replace("encoder.stages.", "stage")
        # stage{i}.layers.{j}. -> stage{i}.blocks.{j}.
        k = k.replace(".layers.", ".blocks.")
        for old, new in _HF_CVT_RENAMES:
            k = k.replace(old, new)
        k = k.replace("layernorm.", "norm.")  # CvtForImageClassification
        out[k] = v
    return out


def convert_cvt(sd: Dict[str, np.ndarray], depths) -> Dict:
    """CvT state_dict (official microsoft / reference layout, or HF
    transformers CvtModel) -> ``{"params", "batch_stats"}`` for
    ``models.cvt.CvT``.

    The reference loads CvT-w24-384x384-IN-22k.pth into its vendored
    cls_cvt modules (Spatial_transformer/models/backbone.py:202-214); this
    maps that layout onto the flax tree: depthwise conv OIHW (C,1,3,3) ->
    HWIO (3,3,1,C), BatchNorm running stats -> batch_stats collection.
    """
    sd = _cvt_canonical(sd)
    params: Dict = {}
    stats: Dict = {}
    for si, depth in enumerate(depths):
        st = f"stage{si}"
        params[f"embed{si}"] = {
            "kernel": _conv(sd[f"{st}.patch_embed.proj.weight"]),
            "bias": sd[f"{st}.patch_embed.proj.bias"]}
        params[f"embed_norm{si}"] = {
            "scale": sd[f"{st}.patch_embed.norm.weight"],
            "bias": sd[f"{st}.patch_embed.norm.bias"]}
        if f"{st}.cls_token" in sd:
            params["cls_token"] = sd[f"{st}.cls_token"]
        for bi in range(depth):
            t = f"{st}.blocks.{bi}"
            attn: Dict = {}
            attn_stats: Dict = {}
            for tk, ours in (("q", "proj_q"), ("k", "proj_k"),
                             ("v", "proj_v")):
                bn_p, bn_s = _bn(sd, f"{t}.attn.conv_proj_{tk}.bn")
                attn[ours] = {
                    "dw": {"kernel": _conv(
                        sd[f"{t}.attn.conv_proj_{tk}.conv.weight"])},
                    "bn": bn_p}
                attn_stats[ours] = {"bn": bn_s}
                attn[tk] = {"kernel": _dense(sd[f"{t}.attn.proj_{tk}.weight"]),
                            "bias": sd[f"{t}.attn.proj_{tk}.bias"]}
            attn["proj"] = {"kernel": _dense(sd[f"{t}.attn.proj.weight"]),
                            "bias": sd[f"{t}.attn.proj.bias"]}
            params[f"stage{si}_block{bi}"] = {
                "norm1": {"scale": sd[f"{t}.norm1.weight"],
                          "bias": sd[f"{t}.norm1.bias"]},
                "norm2": {"scale": sd[f"{t}.norm2.weight"],
                          "bias": sd[f"{t}.norm2.bias"]},
                "attn": attn,
                "mlp": {
                    "Dense_0": {"kernel": _dense(sd[f"{t}.mlp.fc1.weight"]),
                                "bias": sd[f"{t}.mlp.fc1.bias"]},
                    "Dense_1": {"kernel": _dense(sd[f"{t}.mlp.fc2.weight"]),
                                "bias": sd[f"{t}.mlp.fc2.bias"]},
                },
            }
            stats[f"stage{si}_block{bi}"] = {"attn": attn_stats}
    if "norm.weight" in sd:
        params["norm"] = {"scale": sd["norm.weight"],
                          "bias": sd["norm.bias"]}
    else:
        # HF CvtModel carries no final LayerNorm (it lives in the
        # classification head); identity matches a fresh init.
        dim = params[f"embed{len(depths) - 1}"]["bias"].shape[0]
        params["norm"] = {"scale": np.ones(dim, np.float32),
                          "bias": np.zeros(dim, np.float32)}
    return {"params": params, "batch_stats": stats}


def convert_swin(sd: Dict[str, np.ndarray], depths) -> Dict:
    """Official microsoft/timm Swin state dict (``patch_embed.*``,
    ``layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
    mlp.fc2}``, ``layers.{s}.downsample.{norm,reduction}``, ``norm``) ->
    ``{"params"}`` of the headless backbone (a ``head`` is left out)."""
    params: Dict = {}
    params["patch_embed"] = {"kernel": _conv(sd["patch_embed.proj.weight"]),
                             "bias": sd["patch_embed.proj.bias"]}
    if "patch_embed.norm.weight" in sd:
        params["patch_norm"] = {"scale": sd["patch_embed.norm.weight"],
                                "bias": sd["patch_embed.norm.bias"]}
    for si, depth in enumerate(depths):
        for bi in range(depth):
            t = f"layers.{si}.blocks.{bi}"
            params[f"stage{si}_block{bi}"] = {
                "norm1": {"scale": sd[f"{t}.norm1.weight"],
                          "bias": sd[f"{t}.norm1.bias"]},
                "norm2": {"scale": sd[f"{t}.norm2.weight"],
                          "bias": sd[f"{t}.norm2.bias"]},
                "attn": {
                    "qkv": {"kernel": _dense(sd[f"{t}.attn.qkv.weight"]),
                            "bias": sd[f"{t}.attn.qkv.bias"]},
                    "proj": {"kernel": _dense(sd[f"{t}.attn.proj.weight"]),
                             "bias": sd[f"{t}.attn.proj.bias"]},
                    "relative_position_bias_table":
                        sd[f"{t}.attn.relative_position_bias_table"],
                },
                "mlp": {
                    "Dense_0": {"kernel": _dense(sd[f"{t}.mlp.fc1.weight"]),
                                "bias": sd[f"{t}.mlp.fc1.bias"]},
                    "Dense_1": {"kernel": _dense(sd[f"{t}.mlp.fc2.weight"]),
                                "bias": sd[f"{t}.mlp.fc2.bias"]},
                },
            }
        if si < len(depths) - 1:
            d = f"layers.{si}.downsample"
            params[f"merge{si}"] = {
                "norm": {"scale": sd[f"{d}.norm.weight"],
                         "bias": sd[f"{d}.norm.bias"]},
                "reduction": {"kernel": _dense(sd[f"{d}.reduction.weight"])},
            }
    params["norm"] = {"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
    return {"params": params}
