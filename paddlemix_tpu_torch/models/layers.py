"""Transformer encoder building blocks (port of paddlemix_tpu/models/layers.py).

Parameter names follow HF transformers (self_attn.{q,k,v,out}_proj,
layer_norm1/2, mlp.fc1/fc2), which the JAX package's CLIP key map renames.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import get_activation, scaled_dot_product_attention


class MultiHeadAttention(nn.Module):
    """Self-attention over (B, S, D) hidden states (q/k/v/out projections with bias)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, hidden, *, causal=False):
        b, s = hidden.shape[:2]
        q, k, v = (proj(hidden).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        attn = scaled_dot_product_attention(q, k, v, causal=causal)
        return self.out_proj(attn.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, dim: int, intermediate_size: int, activation: str = "gelu"):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate_size)
        self.act = get_activation(activation)
        self.fc2 = nn.Linear(intermediate_size, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (CLIP/ViT style)."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 activation: str = "gelu", eps: float = 1e-5):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = MLP(dim, intermediate_size, activation)

    def forward(self, x, *, causal=False):
        x = x + self.self_attn(self.layer_norm1(x), causal=causal)
        return x + self.mlp(self.layer_norm2(x))


class PatchEmbed(nn.Conv2d):
    """Image -> patch tokens: a patch_size-strided conv over NHWC pixels (the
    JAX package's layout) returning (B, num_patches, embed_dim), patches in
    row-major order. The conv itself runs on the NCHW view."""

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 use_bias: bool = True):
        super().__init__(in_channels, embed_dim, kernel_size=patch_size, stride=patch_size,
                         bias=use_bias)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = super().forward(pixels.permute(0, 3, 1, 2).to(self.weight.dtype))
        return x.flatten(2).transpose(1, 2)
