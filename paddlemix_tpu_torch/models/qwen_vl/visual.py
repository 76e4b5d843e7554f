"""Qwen-VL (v1)'s visual tower: ViT-bigG and its cross-attention Resampler
(port of paddlemix_tpu/models/qwen_vl/visual.py).

The trunk: a bias-less conv patch embedding (no class token), the learned
16 x 16 position table resized bicubically to the patch grid (`get_abs_pos`),
ln_pre, then pre-LN blocks: ln_1, the fused in_proj split per head
(..., heads, 3 hd) into q | k | v, attention, out_proj; ln_2, c_fc, exact
GELU, c_proj. The Resampler: 256 learned queries (ln_q) cross-attend the
patch features (kv_proj, no bias, then ln_kv), a 2-D sincos table added to
query and key (the key's resized to the grid), 32 heads of 128 at
Qwen-VL's 4,096; then ln_post and `x @ proj`.

Kernels, each launched for CUDA tensors (plain versions on the CPU): every
LayerNorm on B10 (1,664 wide in the trunk, 4,096 in the Resampler; the JAX
tower uses flax's LayerNorm, the port's towers route it to the kernel), the
trunk's attention (1,024 tokens, 16 heads of 104, read in place on the D 128
core) and the Resampler's (256 queries over 1,024 keys, 32 heads of 128)
through `scaled_dot_product_attention` (B1). The trunk's q, k and v are
strided views of the one projection, read in place.

Modules are named as the JAX module names them (`conv1`,
`positional_embedding`, `ln_pre`, `resblocks.N.{ln_1, in_proj, out_proj,
ln_2, c_fc, c_proj}`, `attn_pool.{query, pos_embed, kv_proj, ln_kv, ln_q,
q_proj, k_proj, v_proj, out_proj}`, `ln_post`, `proj` (its flax layout,
(in, out))); `core.convert.QWEN_VL_KEY_MAP` gives their flax keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...ops import scaled_dot_product_attention
from ..layers import FusedLayerNorm, PatchEmbed


@dataclasses.dataclass
class QwenVisionConfig(BaseConfig):
    """Defaults are Qwen-VL's ViT-bigG (448 px, patches of 14, 1,664 wide, 48
    layers, 16 heads, MLP ratio 4.9231, output 4,096)."""

    model_type = "qwen_vision"
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_ratio: float = 4.9231
    output_dim: int = 4096
    pos_embed_size: int = 16  # sqrt of the stored position table's length (256)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size^2, embed_dim) 2-D sincos table (copy of the JAX package's)."""
    def one_dim(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    emb_h = one_dim(embed_dim // 2, grid[0])
    emb_w = one_dim(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix of torch's `F.interpolate(mode="bicubic",
    align_corners=False)` (a = -0.75, the border clamped) (copy of the JAX
    package's)."""
    a = -0.75

    def cubic(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        for t in range(-1, 3):
            j = x0 + t
            m[i, min(max(j, 0), src - 1)] += cubic(x - j)
    return m.astype(np.float32)


def get_abs_pos(pos_embed, tgt_len: int):
    """A (S*S, D) position table resized bicubically to (T*T, D), T =
    sqrt(tgt_len), in fp32 and cast back; the table itself where S == T."""
    src = int(round(float(np.sqrt(pos_embed.shape[0]))))
    tgt = int(round(float(np.sqrt(tgt_len))))
    if src == tgt:
        return pos_embed
    m = torch.from_numpy(_bicubic_matrix(src, tgt)).to(pos_embed.device)
    x = pos_embed.reshape(src, src, -1).float()
    x = torch.einsum("ts,shd->thd", m, x)
    x = torch.einsum("us,hsd->hud", m, x)
    return x.reshape(tgt * tgt, -1).to(pos_embed.dtype)


class VisualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.ln_1 = FusedLayerNorm(width, eps=1e-6)
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = FusedLayerNorm(width, eps=1e-6)
        self.c_fc = nn.Linear(width, int(width * mlp_ratio))
        self.c_proj = nn.Linear(int(width * mlp_ratio), width)

    def split_qkv(self, x):
        """q, k, v (B, N, heads, hd) of x (B, N, width): views of the one
        projection, split per head, (..., heads, 3 hd) -> q | k | v (the
        reference's layout, qwen_vit.py:78-86)."""
        b, n, d = x.shape
        return self.in_proj(x).view(b, n, self.heads, 3 * d // self.heads).chunk(3, dim=-1)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.split_qkv(self.ln_1(x))
        x = x + self.out_proj(scaled_dot_product_attention(q, k, v).reshape(b, n, d))
        return x + self.c_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="none"))


class Resampler(nn.Module):
    """`num_queries` learned queries cross-attend the patch features once,
    the 2-D sincos table added to query and key."""

    def __init__(self, num_queries: int, out_dim: int, num_heads: int, kv_dim: int):
        super().__init__()
        self.grid = int(np.sqrt(num_queries))
        nq = self.grid * self.grid  # the reference's: int(sqrt(n))^2
        self.num_heads = num_heads
        self.query = nn.Parameter(torch.zeros(nq, out_dim))
        self.pos_embed = nn.Parameter(torch.from_numpy(get_2d_sincos_pos_embed(out_dim,
                                                                               self.grid)))
        self.kv_proj = nn.Linear(kv_dim, out_dim, bias=False)
        self.ln_kv = FusedLayerNorm(out_dim, eps=1e-6)
        self.ln_q = FusedLayerNorm(out_dim, eps=1e-6)
        self.q_proj = nn.Linear(out_dim, out_dim)
        self.k_proj = nn.Linear(out_dim, out_dim)
        self.v_proj = nn.Linear(out_dim, out_dim)
        self.out_proj = nn.Linear(out_dim, out_dim)

    @torch.no_grad()
    def init_params_(self, generator):
        """The JAX inits (`core.init`): the queries at std 0.02, the sincos
        table."""
        self.query.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.copy_(torch.from_numpy(get_2d_sincos_pos_embed(self.query.shape[1],
                                                                      self.grid)))

    def forward(self, image_feats):
        b, n, _ = image_feats.shape
        nq, d = self.query.shape
        hd = d // self.num_heads
        kv = self.ln_kv(self.kv_proj(image_feats))
        q = self.ln_q(self.query.to(kv.dtype))
        pos = self.pos_embed
        q_in = (q + pos.to(q.dtype))[None].expand(b, nq, d)
        k_in = kv + get_abs_pos(pos, n).to(kv.dtype)[None]
        qq = self.q_proj(q_in).view(b, nq, self.num_heads, hd)
        kk = self.k_proj(k_in).view(b, n, self.num_heads, hd)
        vv = self.v_proj(kv).view(b, n, self.num_heads, hd)
        return self.out_proj(scaled_dot_product_attention(qq, kk, vv).reshape(b, nq, d))


class QwenVisionTransformer(nn.Module):
    """Pixels (B, H, W, 3) NHWC -> (B, num_queries, output_dim)."""

    def __init__(self, cfg: QwenVisionConfig, num_queries: int = 256):
        super().__init__()
        self.config = cfg
        self.conv1 = PatchEmbed(cfg.patch_size, cfg.width, use_bias=False)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.pos_embed_size ** 2, cfg.width))
        self.ln_pre = FusedLayerNorm(cfg.width, eps=1e-6)
        self.resblocks = nn.ModuleList(VisualAttentionBlock(cfg.width, cfg.heads, cfg.mlp_ratio)
                                       for _ in range(cfg.layers))
        self.attn_pool = Resampler(num_queries, cfg.output_dim, max(cfg.output_dim // 128, 1),
                                   cfg.width)
        self.ln_post = FusedLayerNorm(cfg.output_dim, eps=1e-6)
        self.proj = nn.Parameter(torch.zeros(cfg.output_dim, cfg.output_dim))

    @torch.no_grad()
    def init_params_(self, generator):
        """The JAX inits (`core.init`): the position table at std width^-0.5,
        `proj` at std output_dim^-0.5."""
        cfg = self.config
        self.positional_embedding.normal_(0.0, cfg.width ** -0.5, generator=generator)
        self.proj.normal_(0.0, cfg.output_dim ** -0.5, generator=generator)

    def forward(self, pixel_values):
        x = self.conv1(pixel_values)
        x = x + get_abs_pos(self.positional_embedding, x.shape[1]).to(x.dtype)
        x = self.ln_pre(x)
        for block in self.resblocks:
            x = block(x)
        x = self.ln_post(self.attn_pool(x))
        return x @ self.proj.to(x.dtype)
