"""SD3 MM-DiT, the dual-stream joint-attention diffusion transformer (port of
paddlemix_tpu/diffusers/models/transformer_sd3.py).

Module names are the JAX package's flax names, so the key map copied in
core/convert.py (`SD3_KEY_MAP`) only renumbers the blocks and renames
`.weight` to `.kernel`; image and context streams keep their fused q/k/v
projections (`attn_qkv`, `attn_add_qkv`).

The modulated norms run the adaLN kernels of ops/norms.py (B12
`adaptive_layer_norm`, B13 `fused_adaln_scale_residual`) on the model's own
dtype: the kernels widen to fp32 and round once, which is what the JAX model
computes by casting to fp32 around its Pallas calls. The joint attention
(context tokens first, then image tokens) is routed to flash or math by
`use_flash`; at SD3-medium's 1024 px it is flash over 4,250 tokens.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import scaled_dot_product_attention
from ...ops.norms import adaptive_layer_norm, fused_adaln_scale_residual
from .embeddings import PatchEmbed2D, TimestepEmbedding, Timesteps


@dataclasses.dataclass
class SD3TransformerConfig:
    """Defaults are SD3-medium's published widths
    (stabilityai/stable-diffusion-3-medium-diffusers, transformer/config.json).
    The JAX config's `caption_projection_dim` and `pos_embed_max_size` are
    unused there and left out: the position table is computed for the grid."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 2048
    out_channels: int = 16
    gradient_checkpointing: bool = False

    def __post_init__(self):
        if self.gradient_checkpointing:
            raise NotImplementedError("SD3TransformerConfig: gradient checkpointing (training) "
                                      "is not ported")

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


class JointTransformerBlock(nn.Module):
    """One MM-DiT block: separate image / context streams with adaLN-zero
    modulation (6 vectors each), joint attention over [context, image]. The
    last block is `context_pre_only`: its context stream has 2 modulation
    vectors (shift, scale), still feeds its keys and values to the joint
    attention, and returns no context."""

    def __init__(self, num_heads: int, head_dim: int, context_pre_only: bool = False):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.context_pre_only = context_pre_only
        self.norm1_linear = nn.Linear(d, 6 * d)
        self.norm1_context_linear = nn.Linear(d, (2 if context_pre_only else 6) * d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_add_qkv = nn.Linear(d, 3 * d)
        self.attn_to_out = nn.Linear(d, d)
        self.ff_fc1 = nn.Linear(d, 4 * d)
        self.ff_fc2 = nn.Linear(4 * d, d)
        if not context_pre_only:
            self.attn_to_add_out = nn.Linear(d, d)
            self.ff_context_fc1 = nn.Linear(d, 4 * d)
            self.ff_context_fc2 = nn.Linear(4 * d, d)

    def _qkv(self, proj, h):
        b, n, _ = h.shape
        return proj(h).view(b, n, 3 * self.num_heads, self.head_dim).split(self.num_heads, dim=2)

    def forward(self, x, context, temb):
        act = F.silu(temb)
        sx, scx, gx, sx2, scx2, gx2 = self.norm1_linear(act).chunk(6, dim=-1)
        mod_c = self.norm1_context_linear(act)
        if self.context_pre_only:
            sc, scc = mod_c.chunk(2, dim=-1)
        else:
            sc, scc, gc, sc2, scc2, gc2 = mod_c.chunk(6, dim=-1)

        hx = adaptive_layer_norm(x, scx, sx)
        hc = adaptive_layer_norm(context, scc, sc)
        qx, kx, vx = self._qkv(self.attn_qkv, hx)
        qc, kc, vc = self._qkv(self.attn_add_qkv, hc)
        nc = context.shape[1]
        attn = scaled_dot_product_attention(torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1),
                                            torch.cat([vc, vx], dim=1))
        attn = attn.flatten(2)
        attn_c, attn_x = attn[:, :nc], attn[:, nc:]

        attn_x = self.attn_to_out(attn_x)
        hx2, x = fused_adaln_scale_residual(x, attn_x, gx, scx2, sx2)
        h = F.gelu(self.ff_fc1(hx2), approximate="tanh")
        x = x + gx2[:, None, :] * self.ff_fc2(h)
        if self.context_pre_only:
            return x, None

        attn_c = self.attn_to_add_out(attn_c)
        hc2, context = fused_adaln_scale_residual(context, attn_c, gc, scc2, sc2)
        h = F.gelu(self.ff_context_fc1(hc2), approximate="tanh")
        context = context + gc2[:, None, :] * self.ff_context_fc2(h)
        return x, context


class SD3Transformer2DModel(nn.Module):
    """forward(latents (B, H, W, C) NHWC, timesteps (B,), encoder_hidden_states
    (B, L, joint_attention_dim), pooled_projections (B, pooled_projection_dim))
    -> (B, H, W, out_channels) in the model's dtype."""

    def __init__(self, config: SD3TransformerConfig):
        super().__init__()
        self.config = cfg = config
        d = cfg.hidden_size
        self.pos_embed = PatchEmbed2D(cfg.patch_size, cfg.in_channels, d,
                                      base_size=cfg.sample_size // cfg.patch_size)
        self.time_proj = Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        self.timestep_embedder = TimestepEmbedding(256, d)
        self.text_embedder = TimestepEmbedding(cfg.pooled_projection_dim, d)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(cfg.num_attention_heads, cfg.attention_head_dim,
                                  context_pre_only=i == cfg.num_layers - 1)
            for i in range(cfg.num_layers)])
        self.norm_out_linear = nn.Linear(d, 2 * d)
        self.proj_out = nn.Linear(d, cfg.patch_size ** 2 * cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    def forward(self, latents, timesteps, encoder_hidden_states, pooled_projections):
        cfg = self.config
        b, hgt, wid, _ = latents.shape
        p = cfg.patch_size
        gh, gw = hgt // p, wid // p
        dtype = self.dtype

        x = self.pos_embed(latents)
        temb = self.timestep_embedder(self.time_proj(timesteps).to(dtype))
        temb = temb + self.text_embedder(pooled_projections.to(dtype))
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        for blk in self.transformer_blocks:
            x, context = blk(x, context, temb)

        shift, scale = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)
        x = self.proj_out(adaptive_layer_norm(x, scale, shift))
        x = x.view(b, gh, gw, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, cfg.out_channels)
