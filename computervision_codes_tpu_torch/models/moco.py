"""TERL's tail-enhanced MoCo: the encoder, the CAM heads and the queue.

Counterpart of ``computervision_codes_tpu/models/moco.py`` (the reference's
TERL/6_baseline_learnT/models/moco.py:85-405):

- ``MoCoEncoder``: a headless Swin (``backbone``), the projection head
  (``--mlp``: ``mlp_fc1``, relu, ``head``), and a 1x1 CAM conv a task over
  the final feature map (``cam_{task}``; with ``ht`` a head and a tail conv,
  ``cam_{task}_head`` / ``cam_{task}_tail``, blended by the class masks),
  whose spatial means are the logits;
- ``CamDisentangle``: a 1x1 conv over the feature map and one CAM channel;
- ``TERLModel``: the two in one module (``encoder``, ``disen``), with
  ``encode`` and ``disentangle`` (the anchors' pooled features and maps);
- ``select_tail_anchors`` (host side, fixed count with a validity mask)
  and ``apply_cam_ivt`` (y_tail: the encoder's ivt CAM conv over anchor
  maps);
- the queue: ``MoCoQueue`` (a module whose buffers are the keys, the four
  label queues, the pointer and the three prototype tables, on the
  module's device), ``init_queue``, ``enqueue`` (a ring write of the valid
  anchors, truncated at the end, then the pointer wraps),
  ``update_prototypes`` (per-class queue means, an empty class keeping its
  prototype), ``moco_logits``, ``prototype_logits``, ``l2_normalize``,
  ``queue_positive_mask``, and ``momentum_update``: the key encoder is an
  EMA copy of the query module, updated in place under ``torch.no_grad()``.

The JAX modules' ``drop_rate`` (a dropout no driver sets; the port's Swin
has none) is left out. Child modules and parameters carry the flax names,
so
``models.convert.load_jax_variables`` maps the JAX tree by name (the
queue's buffers from the ``queue`` collection).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data import bank as bank_mod
from .common import Dense, lecun_normal_
from .swin import VARIANTS as SWIN_VARIANTS, build_swin, swin_feature_dim

TASK_SIZES = {"i": 6, "v": 10, "t": 15, "ivt": 100}


class Conv1x1NHWC(nn.Module):
    """flax ``nn.Conv(features, (1, 1))`` over NHWC maps: ``kernel`` (1, 1,
    Cin, Cout) and ``bias``, lecun-normal and zeros as flax initialises
    them, applied in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(1, 1, cin, cout),
                                                 cin, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return (x.to(self.dtype) @ self.kernel[0, 0].to(self.dtype)
                + self.bias.to(self.dtype))


class MoCoEncoder(nn.Module):
    """Swin backbone + (optionally MLP) projection head + CAM heads.

    ``forward(images (B, H, W, 3), ht_masks=None, generator=None)`` returns
    ``fmap`` (B, h, w, C), ``feature`` (B, C), ``mlp_feat`` (B,
    moco_dim), ``cams`` {task: (B, h, w, n)} and ``logits`` {task: (B, n)};
    ``ht_masks`` {task: (head_mask, tail_mask)} with ``ht``. In ``.train()``
    the Swin blocks draw their DropPath masks from ``generator``.
    """

    def __init__(self, backbone: str = "swin_T_224_1k", moco_dim: int = 128,
                 mlp: bool = True, ht: bool = False, num_triplet: int = 100,
                 fused_train: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.mlp, self.ht, self.dtype = mlp, ht, dtype
        self.backbone = build_swin(backbone, dtype=dtype, generator=g,
                                   fused_train=fused_train)
        c = swin_feature_dim(backbone)
        if mlp:
            self.mlp_fc1 = Dense(c, c, dtype=dtype, generator=g)
        self.head = Dense(c, moco_dim, dtype=dtype, generator=g)
        self.sizes = dict(TASK_SIZES, ivt=num_triplet)
        for task, width in self.sizes.items():
            for tail in (("_head", "_tail") if ht else ("",)):
                self.add_module(f"cam_{task}{tail}",
                                Conv1x1NHWC(c, width, dtype, g))

    def forward(self, images: torch.Tensor, ht_masks=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        out = self.backbone(images, generator)
        fmap, pooled = out["feature_map"], out["pooled"]
        x = torch.relu(self.mlp_fc1(pooled)) if self.mlp else pooled
        mlp_feat = self.head(x)
        cams, logits = {}, {}
        for task in self.sizes:
            if self.ht:
                cam_h = getattr(self, f"cam_{task}_head")(fmap)
                cam_t = getattr(self, f"cam_{task}_tail")(fmap)
                hm, tm = (torch.as_tensor(np.asarray(m), dtype=self.dtype,
                                          device=fmap.device)
                          for m in ht_masks[task])
                cams[task] = cam_h * hm + cam_t * tm
                logits[task] = (cam_h.mean(dim=(1, 2)) * hm
                                + cam_t.mean(dim=(1, 2)) * tm)
            else:
                cams[task] = getattr(self, f"cam_{task}")(fmap)
                logits[task] = cams[task].mean(dim=(1, 2))
        return {"fmap": fmap, "feature": pooled, "mlp_feat": mlp_feat,
                "cams": cams, "logits": logits}


class CamDisentangle(nn.Module):
    """1x1 conv over concat(fmap, one CAM channel) (the reference's
    cam_disen)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv1x1NHWC(channels + 1, channels, dtype, generator)

    def forward(self, fmap: torch.Tensor, cam_slice: torch.Tensor):
        return self.conv(torch.cat([fmap, cam_slice[..., None]], dim=-1))


def select_tail_anchors(tail_labels: np.ndarray, max_anchors: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side anchor selection at a fixed count: ``tail_labels`` (B,
    100) multi-hot tail-triplet labels -> (sample_idx (A,), class_idx (A,),
    valid (A,)), padded to ``max_anchors`` (the reference's
    ``torch.where(labels[0] == 1)``, moco.py:285)."""
    b_idx, c_idx = np.nonzero(tail_labels)
    n = min(len(b_idx), max_anchors)
    sample = np.zeros(max_anchors, np.int32)
    cls = np.zeros(max_anchors, np.int32)
    valid = np.zeros(max_anchors, np.float32)
    sample[:n] = b_idx[:n]
    cls[:n] = c_idx[:n]
    valid[:n] = 1.0
    return sample, cls, valid


def anchor_features(disen: CamDisentangle, enc_out: Dict,
                    sample_idx: torch.Tensor, class_idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The disentangled features of (sample, tail class) anchors: (pooled
    (A, C), maps (A, h, w, C)); the maps feed the ivt CAM head for the tail
    loss (reference moco.py:361 ``y_tail``)."""
    sample_idx, class_idx = sample_idx.long(), class_idx.long()
    fmap = enc_out["fmap"][sample_idx]
    cam = enc_out["cams"]["ivt"][sample_idx]  # (A, h, w, n)
    cam_slice = cam[torch.arange(len(sample_idx), device=cam.device), :, :,
                    class_idx]
    maps = disen(fmap, cam_slice)
    return maps.mean(dim=(1, 2)), maps


class TERLModel(nn.Module):
    """The query path: ``encoder`` (``MoCoEncoder``) and ``disen``
    (``CamDisentangle``) in one module. The key path is an EMA copy of this
    module (``momentum_update``), so encoder_k and cam_disen_k (reference
    :131-135) need no definitions of their own."""

    def __init__(self, backbone: str = "swin_T_224_1k", moco_dim: int = 128,
                 mlp: bool = True, ht: bool = False, num_triplet: int = 100,
                 fused_train: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone, self.moco_dim = backbone, moco_dim
        self.num_triplet, self.dtype = num_triplet, dtype
        self.encoder = MoCoEncoder(backbone, moco_dim, mlp, ht, num_triplet,
                                   fused_train, dtype, generator)
        self.disen = CamDisentangle(swin_feature_dim(backbone)
                                    if backbone in SWIN_VARIANTS else 512,
                                    dtype, generator)

    def forward(self, images, ht_masks=None, generator=None):
        return self.encoder(images, ht_masks, generator)

    encode = forward

    def disentangle(self, enc_out, sample_idx, class_idx):
        """(A,) anchors -> (pooled (A, C), maps (A, h, w, C))."""
        return anchor_features(self.disen, enc_out, sample_idx, class_idx)


def apply_cam_ivt(encoder: MoCoEncoder, maps: torch.Tensor,
                  ht_mask=None) -> torch.Tensor:
    """The encoder's ivt CAM conv over anchor maps -> (A, n_ivt). Under
    ``ht`` the head and tail convs are blended with the class masks, as the
    forward blends them (the reference's y_tail calls a ``cam_ivt`` that
    does not exist in its ht mode, moco.py:361)."""
    if not encoder.ht:
        return encoder.cam_ivt(maps).mean(dim=(1, 2))
    hm, tm = (torch.as_tensor(np.asarray(m), dtype=encoder.dtype,
                              device=maps.device) for m in ht_mask)
    return (encoder.cam_ivt_head(maps).mean(dim=(1, 2)) * hm
            + encoder.cam_ivt_tail(maps).mean(dim=(1, 2)) * tm)


# ---------------------------------------------------------------------------
# the queue


QUEUE_FIELDS = ("feats", "l_ivt", "l_i", "l_v", "l_t", "ptr", "proto_i",
                "proto_v", "proto_t")


class MoCoQueue(nn.Module):
    """The contrastive queue as buffers (the JAX ``MoCoQueue``'s fields):
    ``feats`` (K, dim) float32 L2-normalised keys, ``l_ivt``/``l_i``/
    ``l_v``/``l_t`` (K,) int32 class ids, ``ptr`` () int32, ``proto_i`` (6,
    dim), ``proto_v`` (10, dim), ``proto_t`` (15, dim) float32."""

    def __init__(self, k: int, dim: int):
        super().__init__()
        self.register_buffer("feats", torch.zeros(k, dim))
        for name in ("l_ivt", "l_i", "l_v", "l_t"):
            self.register_buffer(name, torch.zeros(k, dtype=torch.int32))
        self.register_buffer("ptr", torch.zeros((), dtype=torch.int32))
        for task in ("i", "v", "t"):
            self.register_buffer(f"proto_{task}",
                                 torch.zeros(TASK_SIZES[task], dim))


def init_queue(generator: Optional[torch.Generator], k: int, dim: int,
               device="cpu") -> MoCoQueue:
    """Normal keys, L2-normalised; zero labels and pointer; uniform
    prototypes, as the JAX ``init_queue`` draws them (from ``generator``,
    on ``device``)."""
    queue = MoCoQueue(k, dim).to(device)
    with torch.no_grad():
        feats = torch.randn(k, dim, generator=generator, device=device)
        queue.feats.copy_(feats / feats.norm(dim=-1, keepdim=True))
        for task in ("i", "v", "t"):
            proto = getattr(queue, f"proto_{task}")
            proto.copy_(torch.rand(proto.shape, generator=generator,
                                   device=device))
    return queue


@torch.no_grad()
def enqueue(queue: MoCoQueue, keys: torch.Tensor, lab_ivt: torch.Tensor,
            valid: torch.Tensor) -> MoCoQueue:
    """Write the valid anchors' keys and labels at the pointer, in order,
    dropping those past the end; the pointer then moves on by the number
    written, modulo K (reference :176-221)."""
    k = queue.feats.shape[0]
    valid = torch.as_tensor(valid, device=queue.feats.device) > 0
    order = torch.cumsum(valid.int(), 0) - 1
    pos = queue.ptr.long() + order
    ok = valid & (pos < k)
    at, lab = pos[ok], lab_ivt.long()[ok]
    bank = torch.from_numpy(bank_mod.load_bank()).to(queue.feats.device)
    queue.feats[at] = keys[ok].float()
    queue.l_ivt[at] = lab.int()
    for name, col in (("l_i", 1), ("l_v", 2), ("l_t", 3)):
        getattr(queue, name)[at] = bank[lab, col].int()
    queue.ptr.copy_((queue.ptr + int(ok.sum())) % k)
    return queue


@torch.no_grad()
def update_prototypes(queue: MoCoQueue) -> MoCoQueue:
    """Each class's mean of the queue's keys; a class absent from the queue
    keeps its prototype (reference :348-359)."""
    for task in ("i", "v", "t"):
        proto = getattr(queue, f"proto_{task}")
        onehot = F.one_hot(getattr(queue, f"l_{task}").long(),
                           proto.shape[0]).float()  # (K, C)
        counts = onehot.sum(dim=0)[:, None]
        mean = (onehot.t() @ queue.feats) / torch.clamp(counts, min=1.0)
        proto.copy_(torch.where(counts > 0, mean, proto))
    return queue


def moco_logits(q: torch.Tensor, k: torch.Tensor,
                queue: MoCoQueue) -> torch.Tensor:
    """(A, 1 + K): the positive pair's similarity, then the queue's
    (reference :380-383), in float32."""
    q, k = q.float(), k.float()
    return torch.cat([(q * k).sum(dim=-1, keepdim=True),
                      q @ queue.feats.t()], dim=-1)


def prototype_logits(feats: torch.Tensor,
                     queue: MoCoQueue) -> Dict[str, torch.Tensor]:
    f = feats.float()
    return {t: f @ getattr(queue, f"proto_{t}").t() for t in ("i", "v", "t")}


def l2_normalize(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """x / |x| with the squared norm floored at eps^2: exact where |x| >=
    eps, and a gradient bounded by 1 / eps near zero (torch's 1e-12 floor
    lets a near-zero anchor's gradient explode, as the JAX docstring
    records)."""
    sq = x.square().sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


@torch.no_grad()
def momentum_update(model_q: nn.Module, model_k: nn.Module,
                    m: float) -> nn.Module:
    """The key module's parameters <- k m + q (1 - m), in place (reference
    :156-173)."""
    for pk, pq in zip(model_k.parameters(), model_q.parameters()):
        pk.copy_(pk * m + pq * (1.0 - m))
    return model_k


def queue_positive_mask(anchor_labels: torch.Tensor,
                        queue_labels: torch.Tensor) -> torch.Tensor:
    """(A, K) 0/1: the queue entries of the anchor's class (the KCL
    ``torch.eq(labels, queue_label)`` broadcast, loss.py:92)."""
    return (anchor_labels.long()[:, None]
            == queue_labels.long()[None, :]).float()

