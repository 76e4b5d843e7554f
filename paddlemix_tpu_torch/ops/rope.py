"""Rotary position embeddings (port of paddlemix_tpu/ops/rope.py, the plain
rope; NTK scaling and Qwen2-VL's M-RoPE are not ported yet).

Angles are computed in fp32, and cos/sin are cast to q's dtype before the
multiply, as in the JAX package.
"""

from __future__ import annotations

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
