"""Shared model helpers; counterpart of ``models/common.py`` in the JAX package."""

from __future__ import annotations

import torch


def interpolate_1d(x: torch.Tensor, size: int, mode: str = "linear"
                   ) -> torch.Tensor:
    """Resize (B, C, T) tensors over T, as the JAX ``interpolate_1d``.

    * ``linear``: half-pixel centres (torch align_corners=False).
    * ``nearest``: the floor rule src = floor(dst * T_in / T_out).
    """
    t_in = x.shape[-1]
    if t_in == size:
        return x
    pos = torch.arange(size, dtype=torch.float32, device=x.device)
    if mode == "nearest":
        idx = torch.floor(pos * (t_in / size)).long().clamp(0, t_in - 1)
        return x[:, :, idx]
    if mode == "linear":
        src = ((pos + 0.5) * (t_in / size) - 0.5).clamp(0.0, t_in - 1)
        lo = torch.floor(src).long()
        hi = (lo + 1).clamp(max=t_in - 1)
        w = (src - lo).to(x.dtype)
        return x[:, :, lo] * (1 - w) + x[:, :, hi] * w
    raise ValueError(f"unsupported mode {mode!r}")
