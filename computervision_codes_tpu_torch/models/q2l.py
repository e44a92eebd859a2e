"""Query2Label teacher (Swin, ResNet or TResNet backbone + DETR-style
decoder), eval and training forward.

Counterpart of ``models/q2l.py`` in the JAX package: d_model = the
backbone's channels, 4 heads, FFN 8192, one post-norm encoder layer and two
decoder layers without self-attention, one ``Q2LTransformer`` shared by
every task; per task an ``input_proj`` Dense, query embeddings and a
``GroupWiseLinear`` head; the task feature is the mean of the encoder
memory over positions. Attention products are plain ``torch.matmul`` with a
float32 softmax, as XLA computed them in the JAX package.

In training (``.train()``) the transformer drops at the JAX rate of 0.1
(``models/q2l.py:62,89,93,95,119,123,125`` there): the attention weights,
each residual branch and the FFN's ReLU output, from the ``generator``
passed to ``forward``, which the Swin backbone's DropPath draws from too.

The Swin options (``fused_split``, ``quant_eval``, ``quant_min_dim``,
``s2d_embed``, ``fused_train``, ``remat``, ``remat_policy`` ...) go to the
backbone. The int8 teacher is
``Q2L(quant_eval=True, s2d_embed=True)`` with its ``Dense`` layers swapped
for ``models.quant_dense.Int8Dense``.

The TResNet backbones (``models.tresnet``) give d_model = width * 8 * 4
(2432 for TResNet-L), the channels of their last stage; the Swin options do
not apply to them and are ignored, as the JAX module ignores them.

The KD block (``kd_attention``, ``models.spatial_cnn.KDCrossTaskAttention``
over the task feature) exists for ``loss_type="all"`` with a
``teacher_dim``, as the JAX block's parameters exist when its init saw
teacher features (the driver's init): ``forward(images, feat_i, feat_v,
feat_t)`` then returns ``out["kd"]``. ``return_sim_mat`` also returns each
task decoder's last cross-attention map, the mean over heads of the
softmax, ``out["sim_mat"][task]`` (B, K, HW), as the JAX option.

Not ported yet, and refused: the CvT backbones (the zoo slice).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .common import Dense, Dropout, GroupWiseLinear, LayerNorm
from .position_encoding import sine_position_embedding
from .resnet import VARIANTS as RESNET_VARIANTS
from .resnet import build_resnet, feature_dim
from .spatial_cnn import KDCrossTaskAttention, kd_forward
from .swin import VARIANTS as SWIN_VARIANTS
from .swin import build_swin, swin_feature_dim
from .tresnet import VARIANTS as TRESNET_VARIANTS
from .tresnet import build_tresnet
from .tresnet import feature_dim as tresnet_feature_dim

# the reference transformer (its models/transformer.py:347-359)
NUM_HEADS, FFN_DIM, ENCODER_LAYERS, DECODER_LAYERS = 4, 8192, 1, 2
DROPOUT = 0.1  # the JAX Q2LTransformer's rate
TASK_SIZES = {"i": 6, "v": 10, "t": 15, "ivt": 100}


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention's math with separate q/k/v/out Dense
    layers (the JAX package's layout)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(dim, dim, dtype=dtype,
                                      generator=generator))
        self.dropout = Dropout(DROPOUT)

    def forward(self, q, k, v, generator=None, return_attn: bool = False):
        """``return_attn``: also the attention weights averaged over the
        heads, (B, nq, nk), torch.nn.MultiheadAttention's convention."""
        h = self.num_heads
        hd = self.dim // h
        b, nq, _ = q.shape
        nk = k.shape[1]

        def split(t, n):
            return t.reshape(b, n, h, hd).transpose(1, 2)

        attn = (split(self.q_proj(q), nq) * hd ** -0.5) @ split(
            self.k_proj(k), nk).transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        attn = self.dropout(attn, generator)
        out = (attn @ split(self.v_proj(v), nk)).transpose(1, 2)
        out = self.out_proj(out.reshape(b, nq, self.dim))
        return (out, attn.mean(dim=1)) if return_attn else out


class EncoderLayer(nn.Module):
    """Post-norm DETR encoder layer (pos added to q and k only)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.self_attn = MultiHeadAttention(dim, NUM_HEADS, dtype, g)
        self.norm1 = LayerNorm(dim, dtype)
        self.linear1 = Dense(dim, FFN_DIM, dtype=dtype, generator=g)
        self.linear2 = Dense(FFN_DIM, dim, dtype=dtype, generator=g)
        self.norm2 = LayerNorm(dim, dtype)
        self.dropout = Dropout(DROPOUT)

    def forward(self, x, pos, generator=None):
        def drop(t):
            return self.dropout(t, generator)

        qk = x + pos
        x = self.norm1(x + drop(self.self_attn(qk, qk, x, generator)))
        ffn = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm2(x + drop(ffn))


class DecoderLayer(nn.Module):
    """Post-norm DETR decoder layer with self-attention removed."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cross_attn = MultiHeadAttention(dim, NUM_HEADS, dtype, g)
        self.norm2 = LayerNorm(dim, dtype)
        self.linear1 = Dense(dim, FFN_DIM, dtype=dtype, generator=g)
        self.linear2 = Dense(FFN_DIM, dim, dtype=dtype, generator=g)
        self.norm3 = LayerNorm(dim, dtype)
        self.dropout = Dropout(DROPOUT)

    def forward(self, tgt, memory, pos, query_pos, generator=None,
                return_attn: bool = False):
        def drop(t):
            return self.dropout(t, generator)

        attn = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               generator, return_attn)
        sim = None
        if return_attn:
            attn, sim = attn
        tgt = self.norm2(tgt + drop(attn))
        ffn = self.linear2(drop(torch.relu(self.linear1(tgt))))
        tgt = self.norm3(tgt + drop(ffn))
        return (tgt, sim) if return_attn else tgt


class Q2LTransformer(nn.Module):
    """1 encoder + 2 decoder layers, shared across the task decoders."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        for i in range(ENCODER_LAYERS):
            self.add_module(f"encoder{i}", EncoderLayer(dim, dtype,
                                                        generator))
        for i in range(DECODER_LAYERS):
            self.add_module(f"decoder{i}", DecoderLayer(dim, dtype,
                                                        generator))
        self.decoder_norm = LayerNorm(dim, dtype)

    def forward(self, src, pos, query_embed, generator=None,
                return_attn: bool = False):
        """src (B, HW, d), pos (1, HW, d), query_embed (K, d) ->
        (decoded queries (B, K, d), encoder memory (B, HW, d)), and with
        ``return_attn`` the last decoder layer's cross-attention map
        (B, K, HW)."""
        memory = src
        for i in range(ENCODER_LAYERS):
            memory = getattr(self, f"encoder{i}")(memory, pos, generator)
        query = query_embed[None].expand(src.shape[0], -1, -1).to(self.dtype)
        tgt = torch.zeros_like(query)
        sim = None
        for i in range(DECODER_LAYERS):
            last = return_attn and i == DECODER_LAYERS - 1
            tgt = getattr(self, f"decoder{i}")(tgt, memory, pos, query,
                                               generator, last)
            if last:
                tgt, sim = tgt
        if return_attn:
            return self.decoder_norm(tgt), memory, sim
        return self.decoder_norm(tgt), memory


class Q2L(nn.Module):
    """Query2Label with per-task decoders over one shared transformer:
    NHWC frames -> ``{"logits": {task: (B, K)}, "feature": (B, d),
    "task_features": {task: (B, d)}}``, plus ``"kd"`` and ``"sim_mat"``
    (module docstring)."""

    def __init__(self, backbone: str = "swin_L_384_22k",
                 loss_type: str = "all", drop_path_rate: float = 0.1,
                 fused_eval: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 teacher_dim: Optional[int] = None,
                 return_sim_mat: bool = False,
                 **swin_flags):
        super().__init__()
        self.loss_type, self.dtype = loss_type, dtype
        self.return_sim_mat = return_sim_mat
        g = generator
        if backbone in SWIN_VARIANTS:
            self.backbone = build_swin(backbone, drop_path_rate, dtype, g,
                                       fused_eval=fused_eval, **swin_flags)
            dim = swin_feature_dim(backbone)
        elif backbone in RESNET_VARIANTS:
            self.backbone = build_resnet(backbone, frozen_bn=True, dtype=dtype,
                                         generator=g)
            dim = feature_dim(backbone)
        elif backbone in TRESNET_VARIANTS:
            self.backbone = build_tresnet(backbone, dtype, g)
            dim = tresnet_feature_dim(backbone)
        elif backbone.startswith("cvt"):
            raise NotImplementedError(f"backbone {backbone!r} is not ported "
                                      f"yet (the backbone zoo slice)")
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.backbone_name, self.dim = backbone, dim
        self.transformer = Q2LTransformer(dim, dtype=dtype, generator=g)
        for key in self.tasks:
            n = TASK_SIZES[key]
            self.add_module(f"input_proj_{key}",
                            Dense(dim, dim, dtype=dtype, generator=g))
            self.register_parameter(f"query_embed_{key}", nn.Parameter(
                torch.randn(n, dim, generator=g)))
            self.add_module(f"fc_{key}",
                            GroupWiseLinear(n, dim, dtype=dtype, generator=g))
        if loss_type == "all" and teacher_dim:
            self.kd_attention = KDCrossTaskAttention(dim, teacher_dim, dtype,
                                                     g)

    @property
    def tasks(self):
        lt = self.loss_type
        keys = [k for k in ("i", "v", "t") if lt in (k, "all")]
        return keys + (["ivt"] if lt == "all" else [])

    def feature_map(self, images: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        if self.backbone_name in SWIN_VARIANTS:
            return self.backbone(images, generator)["feature_map"]
        return self.backbone(images)["stages"][-1]

    def head(self, fmap: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Dict:
        """The transformer and the task heads over a (B, h, w, d) map."""
        b, h, w, _ = fmap.shape
        pos = torch.as_tensor(sine_position_embedding(h, w, self.dim // 2))
        pos = pos.to(fmap.device, self.dtype).reshape(1, h * w, self.dim)
        src = fmap.reshape(b, h * w, self.dim)
        logits = {k: torch.zeros(b, n, dtype=self.dtype, device=fmap.device)
                  for k, n in TASK_SIZES.items()}
        feats, sims = {}, {}
        for key in self.tasks:
            proj = getattr(self, f"input_proj_{key}")(src)
            res = self.transformer(
                proj, pos, getattr(self, f"query_embed_{key}"), generator,
                self.return_sim_mat)
            hs, memory = res[:2]
            if self.return_sim_mat:
                sims[key] = res[2]
            logits[key] = getattr(self, f"fc_{key}")(hs)
            feats[key] = memory.mean(dim=1)
        feature = feats.get("ivt", next(iter(feats.values())))
        out = {"logits": logits, "feature": feature, "task_features": feats}
        if self.return_sim_mat:
            out["sim_mat"] = sims
        return out

    def forward(self, images, feat_i=None, feat_v=None, feat_t=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``generator``: where a training call draws its dropout and
        DropPath masks (one on the model's device; None draws from
        PyTorch's default generator). ``feat_{i,v,t}`` (B, teacher_dim):
        the teachers' features for the KD block (``loss_type="all"``)."""
        out = self.head(self.feature_map(images, generator), generator)
        if self.loss_type == "all" and feat_i is not None:
            out["kd"] = kd_forward(self, out["feature"], feat_i, feat_v,
                                   feat_t)
        return out
