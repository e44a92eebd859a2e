"""Swin Transformer backbone, eval and training forward.

Counterpart of ``models/swin.py`` in the JAX package: NHWC maps, windows
batched over the whole map, the shift mask built with numpy (additive
-100), a relative-position bias gathered from the (2w-1)^2 table. Child
modules carry the flax names (``patch_embed``, ``stage{s}_block{d}``,
``merge{s}``, ``attn/qkv`` ...) for ``models.convert.load_jax_variables``.

Execution plans of a block in eval (``.eval()``), with the JAX package's
eval gate (``models/swin.py:291-331`` there, taken when ``deterministic``),
chosen when ``fused_eval`` is not False (None, the default, means: use the
kernel functions, which run their plain versions on CPU tensors and launch
the CUDA kernels on CUDA ones):

* the map divides by the window, dim <= 384, the window is even and not
  ``fused_split``: the whole block through K5 (``ops.swin_block``);
* the map divides by the window and dim <= 768: the attention half through
  K3 (``ops.window_mhsa``), then the MLP half through K4 (``ops.mlp_block``);
* otherwise (dim 1536, or a map that does not divide): the plain attention
  half, which pads the map to window multiples, then K4.

``quant_eval`` runs the kernels' int8 branches in every block whose dim is
at least ``quant_min_dim`` (768 by default: stages 2 and 3 of Swin-L). The
kernels take the weights cast to the model dtype and then quantized
(``ops.mlp_block.q8_weight``), as the JAX module passes them; each block
keeps its int8 weights from the first call on and makes them anew only
when a weight changes (a load, a move to another device). ``s2d_embed``
computes the 4x4/4 patch embedding as the exact GEMM over the block-4
space-to-depth view, in the model dtype (``swin.py:426-440`` there).

``fused_eval=False`` runs every block as the JAX package's XLA path does
(``WindowAttention`` and ``Mlp`` modules). The roll of a shifted block stays
outside the kernels, as in the JAX module; a block's shift is dropped when
the map is no larger than its window.

``use_fused_attn`` follows the JAX gate (``swin.py:295-297`` there): such a
block takes the "plain" plan whatever ``fused_eval`` says, and its
``WindowAttention`` runs the attention core through
``ops.window_attention.window_attention_fused`` (K10 on the card;
``fused_block`` windows per TPU grid step, accepted for parity), then the
plain MLP half. So no K3, K4 or K5 runs.

In training (``.train()``) no block takes the eval kernels, and DropPath
follows each branch (one Bernoulli draw per sample from the ``generator``
passed to ``forward``; the masks of a block are drawn before it runs). The
plans, with the JAX gate (``swin.py:296-303`` there):

* ``fused_train``, the map divides by the window, dim <= 768 and not
  ``use_fused_attn`` (the JAX gate's ``dropout == 0`` always holds: the port
  has no Swin dropout, which no configuration sets): "fused_train", the
  attention and MLP branches through K6 (``ops.swin_train``: K3 and K4
  without the residual on the card, their plain versions on the CPU, the
  backward through the plain versions), DropPath and the residual after
  each; at Swin-L-384 stages 0-2;
* otherwise "plain", the JAX XLA path's modules (stage 3 of Swin-L-384, and
  every block without ``fused_train``).

``remat`` runs each block of a training forward under
``torch.utils.checkpoint`` (non-reentrant; the backward replays the block,
K6 included). ``remat_policy="dots"`` (JAX's
``dots_with_no_batch_dims_saveable``) keeps the outputs of the unbatched
matrix products (``aten.mm``, ``aten.addmm``: the Dense layers) and
replays the rest; ``""`` keeps nothing.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.mlp_block import mlp_block_fused, q8_weight
from ..ops.swin_block import swin_block_fused
from ..ops.swin_train import make_attn_branch, make_mlp_branch
from ..ops.window_attention import window_attention_fused
from ..ops.window_mhsa import (window_mhsa_fused, window_partition,
                               window_reverse)
from .common import Dense, DropPath, LayerNorm, Mlp, lecun_normal_, trunc_normal_
from .resnet import Conv2d

VARIANTS = {
    "swin_T_224_1k": dict(embed_dim=96, depths=(2, 2, 6, 2),
                          num_heads=(3, 6, 12, 24), window_size=7),
    "swin_B_224_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), window_size=7),
    "swin_B_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), window_size=12),
    "swin_L_224_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), window_size=7),
    "swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), window_size=12),
    # not in the reference: a miniature variant for the tests
    "swin_nano_64": dict(embed_dim=32, depths=(1, 1, 2, 1),
                         num_heads=(1, 2, 4, 8), window_size=4),
}
MLP_RATIO = 4
# remat_policy -> the aten ops whose outputs a checkpointed block keeps
REMAT_SAVED = {"dots": (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default),
               "": ()}


def _relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # (w*w, w*w)


def _shift_attn_mask(h: int, wd: int, w: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (0 / -100) for shifted windows."""
    img = np.zeros((1, h, wd, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, h // w, w, wd // w, w, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def shift_mask(h: int, wd: int, w: int, shift: int, device: str,
               dtype: torch.dtype) -> torch.Tensor:
    """``_shift_attn_mask`` as a tensor on ``device``, made once per
    geometry (a normal tensor even when first asked for in inference
    mode)."""
    with torch.inference_mode(False):
        return torch.as_tensor(_shift_attn_mask(h, wd, w, shift)).to(
            device, dtype)


class WindowAttention(nn.Module):
    """Multi-head attention within windows: the JAX XLA path, or with
    ``use_fused_kernel`` the core through ``window_attention_fused``."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 use_fused_kernel: bool = False, fused_block: int = 8):
        super().__init__()
        self.window, self.num_heads, self.dtype = window, num_heads, dtype
        self.use_fused_kernel, self.fused_block = use_fused_kernel, fused_block
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, generator=generator,
                         init="trunc_normal")
        self.relative_position_bias_table = nn.Parameter(trunc_normal_(
            torch.empty((2 * window - 1) ** 2, num_heads), 0.02, generator))
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator,
                          init="trunc_normal")
        self.register_buffer(
            "rel_index", torch.as_tensor(_relative_position_index(window)
                                         .reshape(-1)), persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """(heads, N, N) float32 relative-position bias."""
        n = self.window ** 2
        table = self.relative_position_bias_table
        return table[self.rel_index].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, x, mask=None):
        bw, n, c = x.shape  # (B*nW, N, C)
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.use_fused_kernel:
            nw = mask.shape[0] if mask is not None else 1
            out = window_attention_fused(q, k, v,
                                         self.rel_bias().to(self.dtype),
                                         mask, nw, self.fused_block)
            return self.proj(out.transpose(1, 2).reshape(bw, n, c))
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        attn = attn + self.rel_bias()[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, h, n, n) + \
                mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bw, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 drop_path: float = 0.0, fused_eval: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 fused_split: bool = False, quant_eval: bool = False,
                 quant_min_dim: int = 768, use_fused_attn: bool = False,
                 fused_block: int = 8, fused_train: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.shift, self.fused_eval, self.dtype = shift, fused_eval, dtype
        self.fused_split, self.use_fused_attn = fused_split, use_fused_attn
        self.fused_train = fused_train
        self.quant = quant_eval and dim >= quant_min_dim
        self._q8 = (None, None)  # (weights' identity, their Q8Weights)
        g = generator
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, window, num_heads, dtype, g,
                                    use_fused_attn, fused_block)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, MLP_RATIO * dim, dtype, g)
        self.drop_path2 = DropPath(drop_path)

    def plan(self, hgt: int, wid: int) -> str:
        """Which path the block takes on an (hgt, wid) map. In eval:
        "merged" (K5), "split" (K3 + K4), "mlp" (plain attention half + K4)
        or "plain" (with ``use_fused_attn``, K10 inside the plain attention
        half). In training: "fused_train" (K6) or "plain"."""
        w = self.window
        fits = hgt % w == 0 and wid % w == 0 and self.dim <= 768
        if self.training:
            if self.fused_train and fits and not self.use_fused_attn:
                return "fused_train"
            return "plain"
        if self.fused_eval is False or self.use_fused_attn:
            return "plain"
        if fits:
            if self.fused_split or self.dim > 384 or w % 2:
                return "split"
            return "merged"
        return "mlp"

    def q8_weights(self) -> Dict[str, object]:
        """The int8 branch's weights (``Q8Weight``s of the kernels ``qkv``,
        ``proj``, ``Dense_0``, ``Dense_1``), cast to the model dtype and
        then quantized; made once and again only when a weight changes."""
        dense = {"qkv": self.attn.qkv, "proj": self.attn.proj,
                 "Dense_0": self.mlp.Dense_0, "Dense_1": self.mlp.Dense_1}
        key = tuple((d.kernel.data_ptr(), d.kernel._version, d.kernel.device)
                    for d in dense.values())
        if self._q8[0] != key:
            # a normal tensor even when first asked for in inference mode;
            # inference_mode(False) turns grad mode on, so no_grad after it
            with torch.inference_mode(False), torch.no_grad():
                self._q8 = (key, {k: q8_weight(d.kernel.to(self.dtype))
                                  for k, d in dense.items()})
        return self._q8[1]

    def _attn_args(self, x, quant: bool):
        """Shared preamble of the kernel paths: shift gating, the roll, the
        weights (``Q8Weight``s with ``quant``), the bias in the compute
        dtype and the shift mask (or None)."""
        _, hgt, wid, _ = x.shape
        w = self.window
        shift = self.shift if min(hgt, wid) > w else 0
        p = self.attn
        if quant:
            q8 = self.q8_weights()
            wqkv, wproj = q8["qkv"], q8["proj"]
        else:
            wqkv = p.qkv.kernel.to(self.dtype)
            wproj = p.proj.kernel.to(self.dtype)
        args = (self.norm1.scale, self.norm1.bias, wqkv,
                p.qkv.bias.to(self.dtype), wproj, p.proj.bias.to(self.dtype),
                p.rel_bias().to(self.dtype))
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(hgt, wid, w, shift, str(x.device), self.dtype)
        return x, args, mask, shift

    def _mlp_args(self, quant: bool):
        m = self.mlp
        if quant:
            q8 = self.q8_weights()
            w1, w2 = q8["Dense_0"], q8["Dense_1"]
        else:
            w1 = m.Dense_0.kernel.to(self.dtype)
            w2 = m.Dense_1.kernel.to(self.dtype)
        return (self.norm2.scale, self.norm2.bias, w1,
                m.Dense_0.bias.to(self.dtype), w2,
                m.Dense_1.bias.to(self.dtype))

    def _plain_attn_half(self, x, keep=None):
        shortcut = x
        _, hgt, wid, _ = x.shape
        w = self.window
        x = self.norm1(x)
        ph, pw = (w - hgt % w) % w, (w - wid % w) % w
        if ph or pw:  # pad to window multiples, as the reference does
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = hgt + ph, wid + pw
        shift = self.shift if min(hp, wp) > w else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            # 0 / -100 in the compute dtype: the value the attention adds
            mask = shift_mask(hp, wp, w, shift, str(x.device), self.dtype)
        x = self.attn(window_partition(x, w), mask)
        x = window_reverse(x, w, hp, wp)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if ph or pw:
            x = x[:, :hgt, :wid]
        return shortcut + self.drop_path1(x, keep)

    def _fused_train(self, x, keep1, keep2):
        """The JAX ``_fused_train_block``: roll, the K6 attention branch
        (the mask only when shifted), unroll, DropPath and the residual;
        then the K6 MLP branch, DropPath and the residual."""
        xr, args, mask, shift = self._attn_args(x, False)
        fn = make_attn_branch(self.window, self.num_heads, bool(shift))
        if shift:
            branch = torch.roll(fn.apply(xr, *args, mask), (shift, shift),
                                dims=(1, 2))
        else:
            branch = fn.apply(xr, *args)
        x = x + self.drop_path1(branch, keep1)
        mlp = make_mlp_branch().apply(x, *self._mlp_args(False))
        return x + self.drop_path2(mlp, keep2)

    def drop_masks(self, x, generator: Optional[torch.Generator] = None):
        """The two DropPath masks of one call on x (None in eval)."""
        return (self.drop_path1.draw(x, generator),
                self.drop_path2.draw(x, generator))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: where a training call draws its DropPath masks."""
        return self.body(x, *self.drop_masks(x, generator))

    def body(self, x, keep1=None, keep2=None):
        """The block on x with the given DropPath masks (``drop_masks``)."""
        _, hgt, wid, _ = x.shape
        plan = self.plan(hgt, wid)
        w, heads, quant = self.window, self.num_heads, self.quant
        if plan == "fused_train":
            return self._fused_train(x, keep1, keep2)
        if plan in ("merged", "split"):
            xr, args, mask, shift = self._attn_args(x, quant)
            if plan == "merged":
                xr = swin_block_fused(xr, *args, mask, *self._mlp_args(quant),
                                      window=w, num_heads=heads, quant=quant)
            else:
                xr = window_mhsa_fused(xr, *args, mask, window=w,
                                       num_heads=heads, quant=quant)
            if shift:
                xr = torch.roll(xr, (shift, shift), dims=(1, 2))
            if plan == "merged":
                return xr
            return mlp_block_fused(xr, *self._mlp_args(quant), quant=quant)
        x = self._plain_attn_half(x, keep1)
        if plan == "mlp":
            return mlp_block_fused(x, *self._mlp_args(quant), quant=quant)
        return x + self.drop_path2(self.mlp(self.norm2(x)), keep2)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False, dtype=dtype,
                               generator=generator, init="trunc_normal")

    def forward(self, x):
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # torch concat order: (0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(Conv2d):
    """The 4x4 / stride-4 patch conv with bias, flax ``Conv`` padding "SAME"
    (none when H and W divide by 4). NHWC in and out."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(3, embed_dim, 4, 4, 0, dtype, generator, bias=True)
        lecun_normal_(self.weight.data, 4 * 4 * 3, generator)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        ph, pw = -h % 4, -w % 4  # "SAME" at kernel = stride = 4
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return super().forward(x).permute(0, 2, 3, 1)


class SwinTransformer(nn.Module):
    """Headless Swin (as Q2L uses it): NHWC frames ->
    ``{"feature_map": (B, H/32, W/32, C), "pooled": (B, C)}``."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, drop_path_rate: float = 0.1,
                 fused_eval: Optional[bool] = None,
                 use_fused_attn: bool = False, fused_block: int = 8,
                 fused_train: bool = False,
                 remat: bool = False, remat_policy: str = "dots",
                 fused_split: bool = False,
                 quant_eval: bool = False, quant_min_dim: int = 768,
                 s2d_embed: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat_policy not in REMAT_SAVED:
            raise ValueError(f"remat_policy must be one of "
                             f"{list(REMAT_SAVED)}, got {remat_policy!r}")
        self.remat, self.remat_saved = remat, REMAT_SAVED[remat_policy]
        self.dtype, self.depths = dtype, tuple(depths)
        self.s2d_embed, self.embed_dim = s2d_embed, embed_dim
        g = generator
        self.patch_embed = PatchEmbed(embed_dim, dtype, g)
        self.patch_norm = LayerNorm(embed_dim, dtype)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        bi = 0
        for si, depth in enumerate(depths):
            dim = embed_dim * 2 ** si
            for d in range(depth):
                shift = 0 if d % 2 == 0 else window_size // 2
                self.add_module(f"stage{si}_block{d}", SwinBlock(
                    dim, num_heads[si], window_size, shift, float(dpr[bi]),
                    fused_eval, dtype, g, fused_split, quant_eval,
                    quant_min_dim, use_fused_attn, fused_block, fused_train))
                bi += 1
            if si < len(depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(dim, dtype, g))
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.num_features, dtype)

    def _remat_context(self):
        return create_selective_checkpoint_contexts(list(self.remat_saved))

    def stage(self, si: int, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Stage ``si``'s blocks, then its patch merge (if any).
        ``generator``: where a training call draws its DropPath masks."""
        for d in range(self.depths[si]):
            block = getattr(self, f"stage{si}_block{d}")
            if self.remat and self.training and torch.is_grad_enabled():
                # the masks are drawn once, outside: the replay reuses them
                x = checkpoint(block.body, x, *block.drop_masks(x, generator),
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=self._remat_context)
            else:
                x = block(x, generator)
        if si < len(self.depths) - 1:
            x = getattr(self, f"merge{si}")(x)
        return x

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype)
        b, h, w, c = x.shape
        if self.s2d_embed and h % 4 == 0 and w % 4 == 0:
            # stride == kernel: the 4x4/4 conv is the GEMM over the block-4
            # space-to-depth view, (ky, kx, c) minor as the HWIO kernel
            xs = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)
            pe = self.patch_embed
            k = pe.weight.to(self.dtype).permute(2, 3, 1, 0).reshape(
                16 * c, self.embed_dim)
            x = xs @ k + pe.bias.to(self.dtype)
        else:
            x = self.patch_embed(x)
        return self.patch_norm(x)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        x = self.embed(images)
        for si in range(len(self.depths)):
            x = self.stage(si, x, generator)
        x = self.norm(x)
        return {"feature_map": x, "pooled": x.mean(dim=(1, 2))}


def build_swin(name: str, drop_path_rate: float = 0.1,
               dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None,
               **kwargs) -> SwinTransformer:
    if name not in VARIANTS:
        raise ValueError(f"unknown swin variant {name!r}; one of "
                         f"{list(VARIANTS)}")
    return SwinTransformer(drop_path_rate=drop_path_rate, dtype=dtype,
                           generator=generator, **VARIANTS[name], **kwargs)


def swin_feature_dim(name: str) -> int:
    cfg = VARIANTS[name]
    return cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
