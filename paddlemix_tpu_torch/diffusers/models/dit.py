"""DiT, the class-conditional diffusion transformer (port of
paddlemix_tpu/diffusers/models/dit.py).

Module names are the JAX package's flax names, so the key map copied in
core/convert.py (`DIT_KEY_MAP`) only renumbers the blocks and renames
`.weight` to `.kernel` (the label table to `.embedding`).

adaLN-zero: each block's `adaLN_modulation` makes six rows from the
conditioning (timestep + label embedding); the two modulated norms and the
final one run B12 (`ops.norms.adaptive_layer_norm`) on the model's own dtype.
JAX casts x, scale and shift to fp32 around its Pallas call and the result
back; B12 widens to fp32 and rounds once, which is the same on a bf16
residual stream, so nothing is cast here. The fused `qkv` output is laid out
(3, heads, head_dim); q, k and v reach `scaled_dot_product_attention` as
strided views of it, which the flash kernels read in place (no copy). At
DiT-XL/2-256's 256 tokens the attention is flash.

Mixed precision as flax's module `dtype=` gives it: with
`models.layers.set_compute_dtype(model, torch.bfloat16)` every Linear and
the patch conv cast their parameters (fp32 masters in training) and inputs
to bf16 at the call. With `gradient_checkpointing` each block is recomputed
in the backward (`torch.utils.checkpoint`, non-reentrant: JAX's per-block
`nn.remat`).

On the card the model computes in bf16: read it with
`from_pretrained(..., dtype=torch.bfloat16)` (or set a bf16 compute dtype
over fp32 masters). B12 and the flash kernels read bf16 only, so an fp32
model on a CUDA device raises at its first block, where the JAX package
casts to fp32 around its kernel; on the CPU fp32 runs the plain versions.

JAX's LayerNorms here run `adaptive_layer_norm`'s default eps 1e-5; the
original DiT's run 1e-6 (ROADMAP C.36, kept).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.config import BaseConfig
from ...core.convert import DIT_KEY_MAP
from ...models.layers import Conv2d, Linear
from ...ops.attention import scaled_dot_product_attention
from ...ops.norms import adaptive_layer_norm
from .embeddings import LabelEmbedding, TimestepEmbedding, Timesteps, get_2d_sincos_pos_embed


@dataclasses.dataclass
class DiTConfig(BaseConfig):
    """Defaults are DiT-XL/2-256's published widths (facebook/DiT-XL-2-256):
    28 blocks of 16 heads x 72, patch 2 over 32 x 32 x 4 latents, learned
    sigma (8 output channels), 1,000 classes and the null class."""

    model_type = "dit"
    sample_size: int = 32  # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8  # 4 mean + 4 variance (learn_sigma)
    hidden_size: int = 1152
    num_layers: int = 28
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    gradient_checkpointing: bool = False  # per-block recompute in the backward


class DiTBlock(nn.Module):
    """adaLN-zero modulated self-attention and tanh-GELU MLP, gated residuals."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        d = hidden_size
        self.num_heads, self.head_dim = num_heads, d // num_heads
        self.adaLN_modulation = Linear(d, 6 * d)
        self.qkv = Linear(d, 3 * d)
        self.proj = Linear(d, d)
        self.mlp_fc1 = Linear(d, int(d * mlp_ratio))
        self.mlp_fc2 = Linear(int(d * mlp_ratio), d)

    def forward(self, x, c):
        """x: (B, N, D) tokens; c: (B, D) conditioning."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation(F.silu(c)).chunk(6, dim=-1)
        h = adaptive_layer_norm(x, scale_msa, shift_msa)
        b, n, d = x.shape
        q, k, v = self.qkv(h).view(b, n, 3 * self.num_heads, self.head_dim).split(
            self.num_heads, dim=2)
        attn = scaled_dot_product_attention(q, k, v).reshape(b, n, d)
        x = x + gate_msa[:, None, :] * self.proj(attn)
        h = adaptive_layer_norm(x, scale_mlp, shift_mlp)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + gate_mlp[:, None, :] * h


class DiTModel(nn.Module):
    """forward(latents (B, H, W, C) NHWC, timesteps (B,), class_labels (B,)
    int) -> (B, H, W, out_channels) in the model's dtype. `force_drop_ids` /
    `generator` go to the label embedding (CFG's null class)."""

    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'
    flax_key_map = DIT_KEY_MAP  # its names -> the JAX DiTModule's

    def __init__(self, config: DiTConfig):
        super().__init__()
        self.config = cfg = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_proj = Conv2d(cfg.in_channels, d, p, stride=p)
        self.time_proj = Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        self.t_embedder = TimestepEmbedding(256, d)
        self.y_embedder = LabelEmbedding(cfg.num_classes, d, cfg.class_dropout_prob)
        self.blocks = nn.ModuleList([DiTBlock(d, cfg.num_attention_heads, cfg.mlp_ratio)
                                     for _ in range(cfg.num_layers)])
        self.final_adaLN = Linear(d, 2 * d)
        self.final_proj = Linear(d, p * p * cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the model computes in (flax's module dtype)."""
        return self.compute_dtype or self.final_proj.weight.dtype

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "DiTModel":
        """The DiT of directory `path` (or its `subfolder`, e.g.
        "transformer"), flax-keyed as the JAX package and the port write it,
        on `device` with its parameters in `dtype` (the model computes in it)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, DiTConfig, cls.flax_key_map, path, device=device, build=cls,
                               param_dtype=dtype, subfolder=subfolder)

    def save_pretrained(self, directory: str, **kwargs):
        """config.json and flax-keyed safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    def forward(self, latents, timesteps, class_labels, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        b, hgt, wid, _ = latents.shape
        p = cfg.patch_size
        gh, gw = hgt // p, wid // p
        dtype = self.dtype

        x = self.patch_proj(latents.to(dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = x + get_2d_sincos_pos_embed(cfg.hidden_size, gh, gw, base_size=gh,
                                        device=x.device).to(x.dtype)[None]
        t_emb = self.t_embedder(self.time_proj(timesteps).to(dtype))
        y_emb = self.y_embedder(class_labels, force_drop_ids, generator).to(dtype)
        c = t_emb + y_emb
        recompute = cfg.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, c, use_reentrant=False) if recompute else blk(x, c)

        shift, scale = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        x = self.final_proj(adaptive_layer_norm(x, scale, shift))
        x = x.view(b, gh, gw, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, cfg.out_channels)
