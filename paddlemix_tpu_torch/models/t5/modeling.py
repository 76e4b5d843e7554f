"""T5 encoder, SD3's third text tower (port of the encoder side of
paddlemix_tpu/models/t5/modeling.py).

Module names follow HF transformers (shared, encoder.block.N.layer.0.
SelfAttention.{q,k,v,o}, ...layer.0.layer_norm, ...layer.1.DenseReluDense.
{wi_0,wi_1,wo}, encoder.final_layer_norm), which `T5_KEY_MAP` (core/convert.py)
renames to the JAX package's flax names. The one embedding table is `shared`.

T5 attention has no 1/sqrt(d) scale and adds a learned relative position
bias, which block 0 computes and every later block reuses; with a bias the
attention takes the math route. The norms are RMSNorm with an fp32 scale
(`ops.norms.rms_norm`, the B11 kernel on the card).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import scaled_dot_product_attention
from ...ops.norms import rms_norm


@dataclasses.dataclass
class T5Config:
    """Defaults are T5 v1.1-XXL's encoder (SD3's text_encoder_3). The
    feed-forward is T5 v1.1's gated-gelu (tanh form); the JAX package's
    relu and gated-silu variants are not ported."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 buckets (int32) of key - query positions. The log of
    the large distances is taken in fp32 and truncated to int32, as the JAX
    package does."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_if_large)


class T5LayerNorm(nn.Module):
    """RMSNorm without bias; the scale stays fp32 in a bf16 model."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads) if has_relative_bias else None

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, s, s) bias in the table's dtype."""
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, position_bias=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, cfg.num_heads, cfg.d_kv) for proj in (self.q, self.k, self.v))
        if position_bias is None:  # block 0, the one that owns the table
            position_bias = self.position_bias(s, x.device)
        out = scaled_dot_product_attention(q, k, v, bias=position_bias, scale=1.0)
        return self.o(out.reshape(b, s, -1)), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias=None):
        attn, position_bias = self.SelfAttention(self.layer_norm(x), position_bias)
        return x + attn, position_bias


class T5DenseGatedActDense(nn.Module):
    """gelu_tanh(wi_0 h) * wi_1 h -> wo."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)])

    def forward(self, x, position_bias=None):
        x, position_bias = self.layer[0](x, position_bias)
        return self.layer[1](x), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        position_bias = None  # made by block 0, reused by the others
        for blk in self.block:
            x, position_bias = blk(x, position_bias)
        return self.final_layer_norm(x)


class T5EncoderModel(nn.Module):
    """forward(input_ids (B, S)) -> (last_hidden (B, S, d_model), its mean over S)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids):
        x = self.encoder(self.shared(input_ids))
        return x, x.mean(dim=1)
