"""ImageNet warm start: a published torch checkpoint -> the backbone of a
train state.

The port's copy of ``models/pretrained.py`` in the JAX package. The
reference starts every backbone from a local ``../Pretrain`` directory of
official torchvision / microsoft / timm checkpoints
(MT4MTLKD/Spatial_transformer/models/backbone.py:26-41 PTDICT;
Spatial_cnn loads torchvision's resnet weights). ``resolve_checkpoint``
finds the same file names, ``load_backbone_variables`` reads the file and
runs the layout converter (``models/convert.py``), and
``warm_start_backbone`` merges the result into the backbone of a
``train.TrainState``, shape-checked (``_merge``), into its parameters and
its BatchNorm buffers (the ``frozen`` vectors of a Q2L ResNet backbone, the
running statistics of a student's BatchNorm).

No file is fetched: the checkpoint must be on disk. ``URLS`` names where
the published files come from, as text.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .convert import (
    convert_cvt,
    convert_swin,
    convert_torchvision_resnet,
    convert_tresnet,
    jax_variables,
    load_jax_variables,
    load_torch_state_dict,
)

# reference PTDICT (backbone.py:26-41) + the torchvision students the
# Spatial_cnn track loads implicitly
PTDICT = {
    "CvT_w24": "CvT-w24-384x384-IN-22k.pth",
    "swin_L_384_22k": "swin_large_patch4_window12_384_22k.pth",
    "swin_B_384_22k": "swin_base_patch4_window12_384_22k.pth",
    "swin_T_224_1k": "swin_tiny_patch4_window7_224.pth",
    "tresnetl": "tresnet_l_448.pth",
    "tresnetxl": "tresnet_xl_448.pth",
    "tresnetl_v2": "tresnet_l_v2_miil_21k.pth",
    # this repo's variant names for the same files
    "tresnet_l": "tresnet_l_448.pth",
    "tresnet_xl": "tresnet_xl_448.pth",
    "cvt_w24": "CvT-w24-384x384-IN-22k.pth",
    "resnet18": "resnet18-f37072fd.pth",
    "resnet34": "resnet34-b627a593.pth",
    "resnet50": "resnet50-0676ba61.pth",
}

# where the published files come from (text only: nothing here fetches)
URLS = {
    "swin_L_384_22k": "https://github.com/SwinTransformer/storage/releases/"
                      "download/v1.0.0/swin_large_patch4_window12_384_22k.pth",
    "swin_B_384_22k": "https://github.com/SwinTransformer/storage/releases/"
                      "download/v1.0.0/swin_base_patch4_window12_384_22k.pth",
    "swin_T_224_1k": "https://github.com/SwinTransformer/storage/releases/"
                     "download/v1.0.0/swin_tiny_patch4_window7_224.pth",
    "resnet18": "https://download.pytorch.org/models/resnet18-f37072fd.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-b627a593.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-0676ba61.pth",
}


def resolve_checkpoint(backbone: str, path: str) -> str:
    """``path`` may be the .pth itself or a Pretrain-style directory."""
    if os.path.isdir(path):
        if backbone not in PTDICT:
            raise ValueError(f"no known checkpoint filename for {backbone!r};"
                             " pass the .pth path directly")
        path = os.path.join(path, PTDICT[backbone])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained checkpoint not found: {path}"
            + (f" (published at {URLS[backbone]})" if backbone in URLS
               else ""))
    return path


def load_backbone_variables(backbone: str, path: str,
                            frozen_bn: bool = False) -> Dict:
    """Load and convert an official checkpoint into the flax-named
    variables of the port's backbone."""
    sd = load_torch_state_dict(resolve_checkpoint(backbone, path))
    if backbone.startswith("swin"):
        from .swin import VARIANTS as SWIN_VARIANTS

        return convert_swin(sd, SWIN_VARIANTS[backbone]["depths"])
    if backbone.startswith("resnet"):
        from .resnet import VARIANTS as RESNET_VARIANTS

        return convert_torchvision_resnet(sd, RESNET_VARIANTS[backbone][0],
                                          frozen_bn=frozen_bn)
    if backbone.lower().startswith("cvt"):
        return convert_cvt(sd, ())
    if backbone.startswith("tresnet"):
        from .tresnet import VARIANTS as TR_VARIANTS

        return convert_tresnet(sd, TR_VARIANTS[backbone]["layers"])
    raise ValueError(f"no converter for backbone {backbone!r}")


def _merge(dst: Dict, src: Dict, path: str = "") -> Tuple[Dict, list, list]:
    """Replace dst leaves with src leaves where key paths + shapes match.

    Returns (merged, loaded_paths, skipped_paths). Keys present in src but
    absent in dst (e.g. the ImageNet classification head on a headless
    backbone) are skipped; a shape mismatch is an error (wrong variant).
    """
    merged = dict(dst)
    loaded, skipped = [], []
    for k, v in src.items():
        p = f"{path}/{k}"
        if k not in dst:
            skipped.append(p)
            continue
        if isinstance(v, dict):
            sub, ld, sk = _merge(dst[k], v, p)
            merged[k] = sub
            loaded += ld
            skipped += sk
        else:
            want = np.shape(dst[k])
            got = np.shape(v)
            if want != got:
                raise ValueError(f"shape mismatch at {p}: checkpoint {got} "
                                 f"vs model {want} — wrong variant?")
            merged[k] = np.asarray(v, dtype=np.asarray(dst[k]).dtype)
            loaded.append(p)
    return merged, loaded, skipped


def warm_start_backbone(state, backbone: str, path: str, log=print,
                        submodule: str = "backbone"):
    """Return ``state`` with its model's backbone filled from the converted
    checkpoint, in place: its parameters and its BatchNorm buffers. The
    backbone is the module at ``submodule``, a path of child names joined
    by "/" (TERL's ``encoder/backbone``). A backbone holding FrozenBatchNorm
    (the Q2L teacher's ResNet) takes the ``frozen`` layout, else live
    ``batch_stats`` (the CNN student)."""
    module = state.model
    for name in submodule.split("/"):
        module = getattr(module, name)
    dst = jax_variables(module)
    src = load_backbone_variables(backbone, path,
                                  frozen_bn="frozen" in dst)
    merged, loaded, skipped = dict(dst), [], []
    for col in ("params", "batch_stats", "frozen"):
        if col in dst and col in src:
            merged[col], ld, sk = _merge(dst[col], src[col],
                                         f"{col}/{submodule}")
            loaded += ld
            skipped += sk
    if not loaded:
        raise ValueError("warm start loaded nothing: the backbone is "
                         "empty")
    load_jax_variables(module, merged)
    msg = (f"warm-started backbone from {os.path.basename(path)}: "
           f"{len(loaded)} tensors loaded")
    if skipped:
        msg += (f", {len(skipped)} checkpoint keys skipped "
                f"(e.g. {skipped[:3]})")
    log(msg)
    return state
