"""Transformer encoder building blocks (port of paddlemix_tpu/models/layers.py).

Parameter names follow HF transformers (self_attn.{q,k,v,out}_proj,
layer_norm1/2, mlp.fc1/fc2), which the JAX package's CLIP key map renames.

Mixed precision as flax does it: a flax module built with `dtype=bfloat16`
keeps its parameters in their own dtype and casts them, and its inputs, to
bf16 where it computes (Dense, Conv, Embed). The port's modules that do the
same carry a `compute_dtype` (None: compute in the parameters' dtype), which
`set_compute_dtype` sets on a whole model. `LayerNorm` (the UNet's) is one
too; FusedLayerNorm is not: the LayerNorm kernel reads fp32 weights beside
bf16 rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import get_activation, scaled_dot_product_attention
from ..ops.norms import layer_norm


class FusedLayerNorm(nn.Module):
    """LayerNorm on the B10 kernel (port of `FusedLayerNorm`): fp32 `weight`
    and `bias` named as nn.LayerNorm names them, the output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def device_tensor(x, device, dtype=None) -> torch.Tensor:
    """x (a tensor, or a numpy array or list such as a processor returns) as
    a tensor on `device`, in `dtype` where given."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device, dtype=dtype)


def n_layer_norms(module: nn.Module) -> int:
    """B10 launches of one forward of `module`: each FusedLayerNorm runs once."""
    return sum(isinstance(m, FusedLayerNorm) for m in module.modules())


class Linear(nn.Linear):
    """nn.Linear with flax Dense's `dtype`: with a `compute_dtype`, the input,
    weight and bias are cast to it and the product comes out in it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with flax Conv's `dtype`: with a `compute_dtype`, the input,
    kernel and bias are cast to it and the convolution comes out in it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(cd)
        return self._conv_forward(x.to(cd), self.weight.to(cd), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax LayerNorm's `dtype`: with a `compute_dtype`,
    the statistics and the affine run in fp32 on x and the parameters as they
    are (flax promotes them to fp32 there) and the result is cast to it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(cd)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """flax's module `dtype=` on a built model: every submodule with a
    `compute_dtype` computes in `dtype` (None: in its parameters' dtype),
    the parameters staying as they are. Returns `module`."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


class MultiHeadAttention(nn.Module):
    """Self-attention over (B, S, D) hidden states (q/k/v/out projections with bias)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, hidden, *, causal=False):
        b, s = hidden.shape[:2]
        q, k, v = (proj(hidden).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        attn = scaled_dot_product_attention(q, k, v, causal=causal)
        return self.out_proj(attn.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, dim: int, intermediate_size: int, activation: str = "gelu"):
        super().__init__()
        self.fc1 = Linear(dim, intermediate_size)
        self.act = get_activation(activation)
        self.fc2 = Linear(intermediate_size, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (CLIP/ViT style). Its norms run on the
    B10 kernel; the JAX block keeps flax nn.LayerNorm there after a v5e
    measurement (the custom call broke XLA's residual-add fusion), which
    eager PyTorch, with no such fusion, does not share."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 activation: str = "gelu", eps: float = 1e-5):
        super().__init__()
        self.layer_norm1 = FusedLayerNorm(dim, eps=eps)
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.layer_norm2 = FusedLayerNorm(dim, eps=eps)
        self.mlp = MLP(dim, intermediate_size, activation)

    def forward(self, x, *, causal=False):
        x = x + self.self_attn(self.layer_norm1(x), causal=causal)
        return x + self.mlp(self.layer_norm2(x))


class PatchEmbed(nn.Conv2d):
    """Image -> patch tokens: a patch_size-strided conv over NHWC pixels (the
    JAX package's layout) returning (B, num_patches, embed_dim), patches in
    row-major order. The conv itself runs on the NCHW view, in `compute_dtype`
    when it is set, else in the weight's dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, patch_size: int, embed_dim: int, in_channels: int = 3,
                 use_bias: bool = True):
        super().__init__(in_channels, embed_dim, kernel_size=patch_size, stride=patch_size,
                         bias=use_bias)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or self.weight.dtype
        x = self._conv_forward(pixels.permute(0, 3, 1, 2).to(cd), self.weight.to(cd),
                               None if self.bias is None else self.bias.to(cd))
        return x.flatten(2).transpose(1, 2)
