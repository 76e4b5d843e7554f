"""UNet / VAE transformer blocks (port of
paddlemix_tpu/diffusers/models/attention.py, default branches only).

Every attention call goes through ops.scaled_dot_product_attention, whose
shape rule sends the UNet self-attention to the flash kernel and the 77-token
cross-attention and the VAE's 512-wide head to math. Parameter names follow
diffusers (to_q/to_k/to_v/to_out.0, ff.net.0.proj/ff.net.2).

With `quant=True` every projection of the UNet's transformers is a static
a8w8 op (ops/quant.py), called in the JAX order: to_q, to_k, to_v, to_out;
ff proj then net.2; proj_in ... proj_out. The VAE's AttentionBlock2D stays
unquantized, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from ...models.layers import LayerNorm
from ...ops import scaled_dot_product_attention
from ...ops.activations import gelu_exact
from ...ops.quant import conv2d, linear
from .resnet import GroupNormAct


class CrossAttention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v (no bias) + to_out.0."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 cross_dim: Optional[int] = None, quant: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = linear(quant, query_dim, inner, bias=False)
        self.to_k = linear(quant, cross_dim or query_dim, inner, bias=False)
        self.to_v = linear(quant, cross_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([linear(quant, inner, query_dim)])

    def forward(self, hidden, context=None):
        context = hidden if context is None else context
        q, k, v = self.to_q(hidden), self.to_k(context), self.to_v(context)
        b, sq = q.shape[:2]
        sk = k.shape[1]
        out = scaled_dot_product_attention(q.view(b, sq, self.num_heads, self.head_dim),
                                           k.view(b, sk, self.num_heads, self.head_dim),
                                           v.view(b, sk, self.num_heads, self.head_dim))
        return self.to_out[0](out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, quant: bool = False):
        super().__init__()
        self.proj = linear(quant, dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_exact(gate)  # erf at fp32, tanh below (the JAX package's rule)


class GEGLUFeedForward(nn.Module):
    """ff.net.0 (GEGLU proj) -> ff.net.2 (out proj); net.1 is diffusers' dropout slot."""

    def __init__(self, dim: int, quant: bool = False):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, quant), nn.Identity(),
                                  linear(quant, dim * 4, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU feed-forward; pre-LayerNorm
    (eps 1e-6, flax's default, as the JAX package)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_dim: int,
                 quant: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, num_heads, head_dim, quant=quant)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, num_heads, head_dim, cross_dim=cross_dim, quant=quant)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = GEGLUFeedForward(dim, quant)

    def forward(self, hidden, context):
        hidden = hidden + self.attn1(self.norm1(hidden))
        hidden = hidden + self.attn2(self.norm2(hidden), context)
        return hidden + self.ff(self.norm3(hidden))


class _GroupNorm32(GroupNormAct):
    """GroupNorm (eps 1e-6) without activation."""

    def __init__(self, num_channels: int, groups: int = 32):
        super().__init__(num_channels, groups, eps=1e-6, act="none")


class Transformer2DModel(nn.Module):
    """Spatial transformer over an NCHW feature map: norm -> proj_in ->
    blocks -> proj_out, plus the residual."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int, cross_dim: int,
                 num_layers: int = 1, use_linear_projection: bool = False, groups: int = 32,
                 quant: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = _GroupNorm32(in_channels, groups)
        if use_linear_projection:
            self.proj_in = linear(quant, in_channels, inner)
            self.proj_out = linear(quant, inner, in_channels)
        else:
            self.proj_in = conv2d(quant, in_channels, inner, 1)
            self.proj_out = conv2d(quant, inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_heads, head_dim, cross_dim, quant)
             for _ in range(num_layers)])

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return x + residual


class AttentionBlock2D(nn.Module):
    """VAE mid-block single-head self-attention over an NCHW feature map."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = _GroupNorm32(channels, groups)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        out = scaled_dot_product_attention(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
