"""MS-TCT temporal teacher (multi-scale temporal conv-transformer).

Counterpart of ``models/mstct.py`` in the JAX package.
Defaults are the driver's (Temporal_mstct/run.py:306-313 of MT4MTLKD):
embed dims (256, 384, 576, 864), 2 GLR blocks per stage, 8 heads,
mlp_ratio 8, final embedding 512, so head dims 32, 48, 72 and 108.

Sequences are (B, T, C) throughout, as there. Each child carries its flax
name (``encoder/merge{i}``, ``encoder/stage{i}_block{j}/{norm1,grb,norm2,
lrb}``, ``grb/{q,kv,proj}``, ``lrb/{linear1,tc,linear2}``,
``mixer/linear_f*``, ``mixer/linear1..9``, ``classifier/linear_{fuse,
pred}``), so ``models.convert.load_jax_variables`` fills every parameter
from the JAX variables. Attention goes through ``ops.attention.
multi_head_attention``: the plain version on the CPU, kernel K7 on the
card, fed the (B, T, H, D) projections as strided (B, H, T, D) views and
writing its output so that the merge of the heads is a view.

Inside ``parallel.context.sequence_sharded`` (``parallel.long_video.
eval_sharded``) the input is this rank's T shard: the temporal
convolutions take their neighbours' frames (``TemporalConv``), each
attention gathers the keys and values of every shard (K7 over the local
queries and all keys) or, with ``ring_mesh``, runs the ring
(``parallel.ring_attention``: K8's forward per block on the card), and
the mixer's per-scale resize, the identity at stride 1, raises on a
length mismatch. ``MSTCT(ring_mesh=mesh)`` outside a sharded block splits
its input over the mesh's ``seq`` axis itself, rings, and gathers the
result, as JAX's ``shard_map`` does.

In ``.train()`` the forward applies the JAX model's two ``Dropout(0.5)``,
on the input and between ``linear_fuse`` and ``linear_pred`` (the LRB's
dropout is 0 there), with masks drawn from the ``generator`` passed to
``forward``; attention stays ``multi_head_attention`` (K7's forward on the
card, the plain backward), as the JAX training step's ``_mha``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .common import Dense, Dropout, LayerNorm, TemporalConv, interpolate_1d


class TemporalMergingBlock(nn.Module):
    """conv1d(k3) channel projection + LayerNorm."""

    def __init__(self, cin: int, embed_dim: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = TemporalConv(cin, embed_dim, kernel, dtype=dtype,
                                 generator=generator)
        self.norm = LayerNorm(embed_dim, dtype)

    def forward(self, x):
        return self.norm(self.proj(x))


class GlobalRelationalBlock(nn.Module):
    """Full self-attention over the sequence: q, kv, heads, attention,
    proj (trunc-normal Dense layers)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.ring_mesh = None
        kw = dict(dtype=dtype, generator=generator, init="trunc_normal")
        self.q = Dense(dim, dim, **kw)
        self.kv = Dense(dim, 2 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)

    def forward(self, x):
        b, t, c = x.shape
        h = self.num_heads
        q = self.q(x)
        k, v = self.kv(x).split(c, dim=-1)

        def heads(a):  # (B, T, C) -> (B, H, T, D), a view
            return a.reshape(b, t, h, c // h).transpose(1, 2)

        out = self._attention(heads(q), heads(k), heads(v))
        return self.proj(out.transpose(1, 2).reshape(b, t, c))

    def _attention(self, q, k, v):
        from ..parallel import context, ring_attention

        shard = context.active_shard()
        if shard is None and self.ring_mesh is None:
            return multi_head_attention(q, k, v)
        if shard is None:  # split the whole sequence here, ring, gather
            from ..parallel.long_video import eval_sharded

            def local(x):  # (B, T / n, H, D, 3) -> (B, T / n, H, D)
                qkv = (t.transpose(1, 2) for t in x.unbind(-1))
                return self._attention(*qkv).transpose(1, 2)

            return eval_sharded(
                local, torch.stack([q, k, v], -1).transpose(1, 2),
                self.ring_mesh).transpose(1, 2)
        if self.ring_mesh is not None:
            return ring_attention.ring_attention_shard(q, k, v, shard)
        return context.gathered_attention(q, k, v, shard)


class LocalRelationalBlock(nn.Module):
    """linear -> depthwise conv(k3) -> exact GELU -> linear (its dropout is
    0 in the JAX model, so none here)."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, init="trunc_normal")
        self.linear1 = Dense(dim, hidden_dim, **kw)
        self.tc = TemporalConv(hidden_dim, hidden_dim, 3, groups=hidden_dim,
                               dtype=dtype, generator=generator)
        self.linear2 = Dense(hidden_dim, dim, **kw)

    def forward(self, x):
        return self.linear2(F.gelu(self.tc(self.linear1(x))))


class GLRBlock(nn.Module):
    """x + GRB(norm1(x)); x + LRB(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 8.0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.grb = GlobalRelationalBlock(dim, num_heads, dtype, generator)
        self.norm2 = LayerNorm(dim, dtype)
        self.lrb = LocalRelationalBlock(dim, int(dim * mlp_ratio), dtype,
                                        generator)

    def forward(self, x):
        x = x + self.grb(self.norm1(x))
        return x + self.lrb(self.norm2(x))


class TemporalEncoder(nn.Module):
    """4 stages of merge + GLR blocks + LayerNorm; returns every stage."""

    def __init__(self, in_features: int,
                 embed_dims: Sequence[int] = (256, 384, 576, 864),
                 num_heads: int = 8, mlp_ratio: float = 8.0,
                 num_blocks: int = 2, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dims, self.num_blocks = tuple(embed_dims), num_blocks
        cin = in_features
        for si, dim in enumerate(self.embed_dims):
            setattr(self, f"merge{si + 1}",
                    TemporalMergingBlock(cin, dim, dtype=dtype,
                                         generator=generator))
            for bi in range(num_blocks):
                setattr(self, f"stage{si + 1}_block{bi}",
                        GLRBlock(dim, num_heads, mlp_ratio, dtype, generator))
            setattr(self, f"norm{si + 1}", LayerNorm(dim, dtype))
            cin = dim

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for si in range(len(self.embed_dims)):
            x = getattr(self, f"merge{si + 1}")(x)
            for bi in range(self.num_blocks):
                x = getattr(self, f"stage{si + 1}_block{bi}")(x)
            x = getattr(self, f"norm{si + 1}")(x)
            outs.append(x)
        return outs


class TemporalMixer(nn.Module):
    """FPN-style multi-scale mixing: four projections to the embedding,
    nine mixes of the coarsest, concatenated to 4 x embedding."""

    def __init__(self, embed_dims: Sequence[int], embedding_dim: int = 512,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        for i, dim in enumerate(embed_dims):
            setattr(self, f"linear_f{i + 1}", Dense(dim, embedding_dim, **kw))
        for i in range(1, 10):
            setattr(self, f"linear{i}",
                    Dense(embedding_dim, embedding_dim, **kw))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        f1, f2, f3, f4 = feats
        t1 = f1.shape[1]

        def resize(x):
            if x.shape[1] == t1:
                return x
            from ..parallel.context import active_shard

            if active_shard() is not None:
                raise ValueError(f"a stage of length {x.shape[1]} against "
                                 f"{t1} does not shard over the sequence")
            return interpolate_1d(x.transpose(1, 2), t1, "linear"
                                  ).transpose(1, 2)

        _f4 = resize(self.linear_f4(f4))
        _f3 = resize(self.linear_f3(f3))
        _f2 = resize(self.linear_f2(f2))
        _f1 = self.linear_f1(f1)

        def mix(i):
            return getattr(self, f"linear{i}")(_f4)

        f3_v = mix(1) + _f3
        f2_v = mix(2) + _f2
        f1_v = mix(3) + _f1
        f3_t = mix(4) + _f3
        f2_t = mix(5) + _f2
        f1_t = mix(6) + _f1
        f3_ivt = mix(7) + _f3 + f3_v + f3_t
        f2_ivt = mix(8) + _f2 + f2_v + f2_t
        f1_ivt = mix(9) + _f1 + f1_v + f1_t
        return torch.cat([_f4, f3_ivt, f2_ivt, f1_ivt], dim=-1)


class MSTCTClassifier(nn.Module):
    """fuse (Dense) -> Dropout(0.5) -> predict (Dense); the feature it
    returns is the dropped one, as the JAX classifier's."""

    def __init__(self, in_features: int, embedding_dim: int,
                 num_classes: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.linear_fuse = Dense(in_features, embedding_dim, **kw)
        self.dropout = Dropout(0.5)
        self.linear_pred = Dense(embedding_dim, num_classes, **kw)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feat = self.dropout(self.linear_fuse(x), generator)
        return self.linear_pred(feat), feat


class MSTCT(nn.Module):
    """The MS-TCT temporal teacher over cached features (B, T, in_features):
    ``{"logits": (B, T, num_classes), "feature": (B, T, E),
    "concat_feature": (B, T, 4E)}`` in the compute dtype."""

    def __init__(self, in_features: int = 1536,
                 embed_dims: Sequence[int] = (256, 384, 576, 864),
                 num_blocks: int = 2, num_heads: int = 8,
                 mlp_ratio: float = 8.0, final_embedding_dim: int = 512,
                 num_classes: int = 100,
                 dtype: torch.dtype = torch.float32,
                 ring_mesh=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(embed_dims) != 4:
            raise ValueError(f"MSTCT has 4 stages, got embed_dims "
                             f"{tuple(embed_dims)}")
        self.dtype = dtype
        self.dropout = Dropout(0.5)
        self.encoder = TemporalEncoder(in_features, embed_dims, num_heads,
                                       mlp_ratio, num_blocks, dtype,
                                       generator)
        self.mixer = TemporalMixer(embed_dims, final_embedding_dim, dtype,
                                   generator)
        self.classifier = MSTCTClassifier(4 * final_embedding_dim,
                                          final_embedding_dim, num_classes,
                                          dtype, generator)
        self.ring_mesh = ring_mesh

    @property
    def ring_mesh(self):
        """The mesh whose ``seq`` ranks every attention rings over (None:
        gathered attention when sharded, else the whole sequence)."""
        return self._ring_mesh

    @ring_mesh.setter
    def ring_mesh(self, mesh) -> None:
        self._ring_mesh = mesh
        for m in self.modules():
            if isinstance(m, GlobalRelationalBlock):
                m.ring_mesh = mesh

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``generator``: where a training call draws its dropout masks (one
        on the model's device; None draws from PyTorch's default)."""
        x = self.dropout(x.to(self.dtype), generator)
        concat = self.mixer(self.encoder(x))
        logits, feat = self.classifier(concat, generator)
        return {"logits": logits, "feature": feat, "concat_feature": concat}
