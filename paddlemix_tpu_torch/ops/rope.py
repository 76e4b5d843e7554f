"""Rotary position embeddings (port of paddlemix_tpu/ops/rope.py: the plain
rope and Qwen2-VL's M-RoPE, `mrope_cos_sin`; QWen's NTK scaling is the
Llama config's rope base, `LlamaConfig.rope_base`), Qwen2-VL's (h, w) vision
rope (port of the tables of
paddlemix_tpu/models/qwen2_vl/modeling.py `Qwen2VisionTransformer`), and
EVA's 2-D vision rope (port of paddlemix_tpu/models/clip/eva.py
`vision_rope_2d`, `_rotate_interleaved`, `apply_vision_rope`).

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


def mrope_cos_sin(position_ids, head_dim: int, mrope_section, theta: float = 10000.0):
    """Qwen2-VL's M-RoPE: position_ids (3, B, S), the t / h / w streams; the
    sections (e.g. (16, 24, 24), summing to head_dim // 2) are taken twice
    over the duplicated halves, section i from stream i % 3. Returns cos / sin
    (B, S, head_dim). Where the three streams are equal (text, decode steps)
    this is `rope_cos_sin` of that stream, bit for bit. Any other shape (the
    packed (B, S) positions of a language-model loss) raises ValueError: JAX's
    indexing raises IndexError there."""
    if position_ids.ndim != 3 or position_ids.shape[0] != 3:
        raise ValueError(f"mrope_cos_sin: position_ids must be (3, B, S), the t / h / w "
                         f"streams; got {tuple(position_ids.shape)}")
    cos3, sin3 = rope_cos_sin(position_ids, head_dim, theta)  # (3, B, S, D)
    cos_parts, sin_parts, offset = [], [], 0
    for i, sec in enumerate(list(mrope_section) * 2):
        cos_parts.append(cos3[i % 3, ..., offset:offset + sec])
        sin_parts.append(sin3[i % 3, ..., offset:offset + sec])
        offset += sec
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def rope_cos_sin_hw(pos_hw, head_dim: int, theta: float = 10000.0):
    """Qwen2-VL's vision rope: pos_hw (..., P, 2) each patch's (row, column)
    -> cos / sin (..., P, head_dim) laid out [h, w, h, w] in quarters, h the
    first quarter of `rope_cos_sin(row, head_dim // 2)`, w that of the
    column's, for the rotate-half `apply_rope`."""
    half = head_dim // 2
    quarter = half // 2
    cos_h, sin_h = rope_cos_sin(pos_hw[..., 0], half, theta)
    cos_w, sin_w = rope_cos_sin(pos_hw[..., 1], half, theta)
    cos = torch.cat([cos_h[..., :quarter], cos_w[..., :quarter]] * 2, dim=-1)
    sin = torch.cat([sin_h[..., :quarter], sin_w[..., :quarter]] * 2, dim=-1)
    return cos, sin


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
