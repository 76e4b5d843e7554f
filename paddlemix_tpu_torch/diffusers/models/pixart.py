"""PixArt-alpha transformer (port of paddlemix_tpu/diffusers/models/pixart.py):
a DiT-style patch transformer in which one shared adaLN-single projection of
the timestep (`adaln_linear`) feeds every block through the block's own
learned `scale_shift_table`, and text enters by cross-attention over the
projected T5 caption.

Module names are the JAX package's flax names (`PIXART_KEY_MAP` in
core/convert.py renumbers the blocks and renames the UNet-style attention
and feed-forward keys). The self-attention goes through the port's
`CrossAttention`: at PixArt-XL-2-512x512's 1,024 tokens the shape rule sends
it to flash (B1); the cross-attention over 120 caption tokens goes to math,
as JAX's routing sends it. The LayerNorms carry no affine (flax
`nn.LayerNorm(use_bias=False, use_scale=False)`, eps 1e-6), outside any
kernel in JAX too: statistics in fp32, the result in x's dtype, as flax
computes them. The feed-forward is `GEGLUFeedForward` and q / k / v have no
bias, as JAX builds them; diffusers' PixArt-alpha config names a tanh-GELU
feed-forward and biased attention, so published weights would load into
neither package (ROADMAP C.37, kept). `use_additional_conditions` adds the
1024 model's resolution and aspect-ratio embeddings (`res_embedder` over the
(B, 2) resolution's two sinusoids, `ar_embedder` over the (B, 1) ratio's),
as JAX does when they are given.

Mixed precision and per-block `gradient_checkpointing` as in DiT
(`diffusers/models/dit.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.config import BaseConfig
from ...core.convert import PIXART_KEY_MAP
from ...models.layers import Linear
from .attention import CrossAttention, GEGLUFeedForward
from .embeddings import PatchEmbed2D, TimestepEmbedding, Timesteps

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclasses.dataclass
class PixArtConfig(BaseConfig):
    """Defaults are PixArt-XL-2-512x512's published widths
    (PixArt-alpha/PixArt-XL-2-512x512): 28 blocks of 16 heads x 72 over 64 x
    64 x 4 latents, patch 2, learned variance (8 output channels), T5-XXL
    captions (4,096 wide), no micro-conditions."""

    model_type = "pixart"
    sample_size: int = 64  # latent grid (512 px / 8)
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8  # learned variance (eps + var)
    num_layers: int = 28
    num_attention_heads: int = 16
    attention_head_dim: int = 72
    caption_channels: int = 4096  # T5-XXL
    use_additional_conditions: bool = False  # the 1024 model's micro-conditions
    gradient_checkpointing: bool = False  # per-block recompute in the backward

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def _layer_norm(x):
    """flax's non-affine LayerNorm: fp32 statistics, the result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)


class PixArtBlock(nn.Module):
    """Self-attention and GEGLU feed-forward modulated by the shared
    timestep projection plus this block's `scale_shift_table`; plain
    cross-attention to the caption in between."""

    def __init__(self, num_heads: int, head_dim: int):
        super().__init__()
        d = num_heads * head_dim
        self.scale_shift_table = nn.Parameter(torch.zeros(6, d))
        self.attn1 = CrossAttention(d, num_heads, head_dim)
        self.attn2 = CrossAttention(d, num_heads, head_dim)
        self.ff = GEGLUFeedForward(d)

    def forward(self, x, t6, context):
        """x: (B, N, D); t6: (B, 6, D) the shared modulation; context: (B, L, D)."""
        mods = self.scale_shift_table[None].to(x.dtype) + t6
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            (mods[:, i][:, None, :] for i in range(6))
        x = x + gate_msa * self.attn1(_layer_norm(x) * (1 + scale_msa) + shift_msa)
        x = x + self.attn2(x, context)
        return x + gate_mlp * self.ff(_layer_norm(x) * (1 + scale_mlp) + shift_mlp)


class PixArtTransformer2DModel(nn.Module):
    """forward(latents (B, H, W, C) NHWC, timesteps (B,) or a scalar,
    encoder_hidden_states (B, L, caption_channels), resolution (B, 2) and
    aspect_ratio (B, 1) with `use_additional_conditions`) -> (B, H, W,
    out_channels) in the model's dtype. Square latents, as in JAX."""

    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'
    flax_key_map = PIXART_KEY_MAP  # its names -> the JAX PixArtModule's

    def __init__(self, config: PixArtConfig):
        super().__init__()
        self.config = cfg = config
        d = cfg.hidden_size
        self.pos_embed = PatchEmbed2D(cfg.patch_size, cfg.in_channels, d, base_size=None)
        self.time_proj = Timesteps(256)
        self.t_embedder = TimestepEmbedding(256, d)
        if cfg.use_additional_conditions:
            self.res_embedder = TimestepEmbedding(2 * 256, d)
            self.ar_embedder = TimestepEmbedding(256, d)
        self.adaln_linear = Linear(d, 6 * d)
        self.caption_fc1 = Linear(cfg.caption_channels, d)
        self.caption_fc2 = Linear(d, d)
        self.blocks = nn.ModuleList([PixArtBlock(cfg.num_attention_heads, cfg.attention_head_dim)
                                     for _ in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.zeros(2, d))
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the model computes in (flax's module dtype)."""
        return self.compute_dtype or self.proj_out.weight.dtype

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "PixArtTransformer2DModel":
        """The transformer of directory `path` (or its `subfolder`), flax-keyed
        as the JAX package and the port write it, on `device` with its
        parameters in `dtype` (the model computes in it)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, PixArtConfig, cls.flax_key_map, path, device=device,
                               build=cls, param_dtype=dtype, subfolder=subfolder)

    def save_pretrained(self, directory: str, **kwargs):
        """config.json and flax-keyed safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    def forward(self, latents, timesteps, encoder_hidden_states, resolution=None,
                aspect_ratio=None):
        cfg = self.config
        d, p, dtype = cfg.hidden_size, cfg.patch_size, self.dtype
        b = latents.shape[0]
        grid = latents.shape[1] // p

        x = self.pos_embed(latents.to(dtype))
        timesteps = torch.as_tensor(timesteps, device=latents.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        t = self.t_embedder(self.time_proj(timesteps).to(dtype))
        if cfg.use_additional_conditions and resolution is not None:
            r = self.time_proj(resolution.reshape(-1)).reshape(b, -1)
            a = self.time_proj(aspect_ratio.reshape(-1)).reshape(b, -1)
            t = t + self.res_embedder(r.to(dtype)) + self.ar_embedder(a.to(dtype))
        t6 = self.adaln_linear(F.silu(t)).view(b, 6, d)
        c = self.caption_fc2(F.gelu(self.caption_fc1(encoder_hidden_states.to(dtype)),
                                    approximate="tanh"))
        recompute = cfg.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, t6, c, use_reentrant=False) if recompute else blk(x, t6, c)

        shift, scale = (self.scale_shift_table[None].to(x.dtype) + t[:, None, :]).unbind(1)
        x = self.proj_out(_layer_norm(x) * (1 + scale[:, None]) + shift[:, None])
        x = x.view(b, grid, grid, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, grid * p, grid * p, cfg.out_channels)
