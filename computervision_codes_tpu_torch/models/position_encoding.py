"""DETR-style 2D sine position embedding.

The port's own copy of ``models/position_encoding.py:17
sine_position_embedding`` in the JAX package (numpy, no JAX): normalised
coordinates, scale 2*pi, temperature 1e4, channels-last (H, W, 2 * F).
"""

from __future__ import annotations

import math

import numpy as np


def sine_position_embedding(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """(H, W, 2*num_pos_feats) float32 sine/cosine grid (normalized)."""
    eps = 1e-6
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, axis=1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, axis=0)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = temperature ** (
        2 * (np.arange(num_pos_feats, dtype=np.float32) // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)
