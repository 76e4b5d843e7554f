"""Rotary position embeddings (port of paddlemix_tpu/ops/rope.py, the plain
rope; NTK scaling and Qwen2-VL's M-RoPE are not ported yet), and EVA's 2-D
vision rope (port of paddlemix_tpu/models/clip/eva.py `vision_rope_2d`,
`_rotate_interleaved`, `apply_vision_rope`).

Angles are computed in fp32, and cos/sin are cast to q's dtype before the
multiply, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0, scaling: float = 1.0):
    """positions: (..., S) int -> cos/sin: (..., S, head_dim), the two halves
    duplicated."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * inv_freq / scaling
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q/k: (B, S, H, D) or (B, S, D); cos/sin: (B, S, D) or (S, D)."""
    if q.ndim == 4 and cos.ndim == 3:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    elif q.ndim == 4 and cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def vision_rope_2d(grid: int, head_dim: int, pt_seq_len: int = 16, intp_freq: bool = True,
                   theta: float = 10000.0, device=None):
    """EVA's interleaved 2-D rope tables over a grid x grid patch grid: the
    patch's row drives the first half of head_dim, its column the second,
    each frequency repeated twice for the pairwise rotation; with
    `intp_freq` the positions are interpolated to the pretraining grid
    (t = i / grid * pt_seq_len). Computed in fp64 with numpy, as the JAX
    package does; returns (grid * grid, head_dim) fp32 cos and sin."""
    dim = head_dim // 2
    freqs = 1.0 / theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim)
    t = (np.arange(grid) / grid * pt_seq_len) if intp_freq else np.arange(grid)
    band = np.repeat(np.outer(t, freqs), 2, axis=-1)              # (g, dim)
    fh = np.broadcast_to(band[:, None, :], (grid, grid, dim))     # rows
    fw = np.broadcast_to(band[None, :, :], (grid, grid, dim))     # columns
    full = np.concatenate([fh, fw], axis=-1).reshape(grid * grid, head_dim)
    return (torch.tensor(np.cos(full), dtype=torch.float32, device=device),
            torch.tensor(np.sin(full), dtype=torch.float32, device=device))


def rotate_interleaved(x):
    """(..., 2k): each pair (x0, x1) becomes (-x1, x0), the interleaved
    rotation (the LLM rope's `rotate_half` rotates the two halves instead)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_vision_rope(x, cos, sin):
    """x (B, N, H, D), cos / sin (N, D): x cos + rotate_interleaved(x) sin in
    fp32, cast back to x's dtype."""
    c, s = cos[None, :, None, :].float(), sin[None, :, None, :].float()
    xf = x.float()
    return (xf * c + rotate_interleaved(xf) * s).to(x.dtype)
