"""InternViT, InternVL2's vision tower (port of
paddlemix_tpu/models/internvl2/intern_vit.py).

A conv patch embedding with bias, a class token and the position table
(bicubic-resized to the patch grid where the grid is not the table's, the
class row kept), then encoder layers: norm1, attention on a fused qkv split
into global thirds (B, N, 3, H, D), with an optional RMSNorm of q and k over
the flattened heads (`qk_normalization`, InternViT-6B's), proj; the layer
scale ls1; norm2, fc1, exact GELU, fc2, the layer scale ls2. The norms are
LayerNorms or RMSNorms (`norm_type`); there is no final norm.

Kernels, each launched for CUDA tensors (plain versions on the CPU): every
LayerNorm on B10 (`FusedLayerNorm`), every RMSNorm on B11 (the Llama's
`RMSNorm`), as the port's other towers route them (the JAX tower uses flax's
norms); the attention through `scaled_dot_product_attention` (B1 at
InternViT-300M's 1,025 tokens, 16 heads of 64), q, k and v handed to it as
strided views of the projection, read in place (no copy) where there is no qk
RMSNorm.

Modules are named as the JAX module names them (`patch_embedding`,
`class_embedding`, `position_embedding`, `layers.N.{norm1, attn.{qkv, q_norm,
k_norm, proj}, ls1, norm2, fc1, fc2, ls2}`); `core.convert.INTERNVL_KEY_MAP`
gives their flax keys.
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
from ..llama.modeling import RMSNorm
from ..qwen_vl.visual import _bicubic_matrix


@dataclasses.dataclass
class InternVisionConfig(BaseConfig):
    model_type = "intern_vit"
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    qkv_bias: bool = True
    qk_normalization: bool = False  # True for InternViT-6B
    norm_type: str = "layer_norm"   # "rms_norm" for InternViT-6B
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    initializer_factor: float = 0.1

    def __post_init__(self):
        if self.norm_type not in ("layer_norm", "rms_norm"):
            raise ValueError(f"InternVisionConfig: norm_type {self.norm_type!r}")
        if self.hidden_act != "gelu":
            raise NotImplementedError(f"InternVisionConfig: hidden_act {self.hidden_act!r} "
                                      f"(the JAX tower runs exact GELU whatever it says)")


def _norm(cfg: InternVisionConfig, dim: int) -> nn.Module:
    if cfg.norm_type == "rms_norm":
        return RMSNorm(dim, cfg.layer_norm_eps)
    return FusedLayerNorm(dim, eps=cfg.layer_norm_eps)


class InternAttention(nn.Module):
    def __init__(self, cfg: InternVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.qkv = nn.Linear(c, 3 * c, bias=cfg.qkv_bias)
        self.qk_normalization = cfg.qk_normalization
        if cfg.qk_normalization:
            self.q_norm = RMSNorm(c, cfg.layer_norm_eps)
            self.k_norm = RMSNorm(c, cfg.layer_norm_eps)
        self.proj = nn.Linear(c, c)

    def split_qkv(self, x):
        """q, k, v (B, N, H, D) of x (B, N, C): views of the one projection,
        global thirds (B, N, 3, H, D) as the reference lays them out."""
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
        return qkv.unbind(2)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.split_qkv(x)
        if self.qk_normalization:  # over the flattened heads (reference :288-290)
            q = self.q_norm(q.reshape(b, n, c)).view(q.shape)
            k = self.k_norm(k.reshape(b, n, c)).view(k.shape)
        return self.proj(scaled_dot_product_attention(q, k, v).reshape(b, n, c))


class InternVisionEncoderLayer(nn.Module):
    def __init__(self, cfg: InternVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.config = cfg
        self.norm1 = _norm(cfg, c)
        self.attn = InternAttention(cfg)
        self.ls1 = nn.Parameter(torch.full((c,), cfg.initializer_factor))
        self.norm2 = _norm(cfg, c)
        self.fc1 = nn.Linear(c, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, c)
        self.ls2 = nn.Parameter(torch.full((c,), cfg.initializer_factor))

    @torch.no_grad()
    def init_params_(self, generator):
        """The layer scales at the config's `initializer_factor`, as the JAX
        layer's constant init (`core.init`)."""
        self.ls1.fill_(self.config.initializer_factor)
        self.ls2.fill_(self.config.initializer_factor)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.to(x.dtype)
        h = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + h * self.ls2.to(x.dtype)


def interpolate_pos(pos, gh: int, gw: int):
    """The (1, 1 + S*S, C) position table for a (gh, gw) patch grid: the table
    itself where the grid is the table's, else the class row kept and the
    S x S grid resized bicubically (torch's `F.interpolate(mode="bicubic",
    align_corners=False)`, as two matrix products in fp32), in fp32."""
    n = pos.shape[1] - 1
    src = int(round(float(np.sqrt(n))))
    if src * src == n and (src, src) == (gh, gw):
        return pos
    body = pos[0, 1:].reshape(src, src, -1).float()
    mh = torch.from_numpy(_bicubic_matrix(src, gh)).to(pos.device)
    mw = torch.from_numpy(_bicubic_matrix(src, gw)).to(pos.device)
    body = torch.einsum("ts,swd->twd", mh, body)
    body = torch.einsum("us,tsd->tud", mw, body)
    return torch.cat([pos[:, :1].float(), body.reshape(1, gh * gw, -1)], dim=1)


class InternVisionModel(nn.Module):
    """Pixels (B, H, W, 3) NHWC -> (last hidden (B, 1 + N, C), the class
    token's row (B, C), the hidden states after the embedding and after each
    layer where asked), the JAX tower's surface. `layers` limits how many
    layers run (the hidden state `extract_feature` selects needs no more)."""

    def __init__(self, cfg: InternVisionConfig):
        super().__init__()
        self.config = cfg
        c = cfg.hidden_size
        self.patch_embedding = PatchEmbed(cfg.patch_size, c)
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, c))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.zeros(1, n_pos, c))
        self.layers = nn.ModuleList(InternVisionEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def embed(self, pixel_values):
        p = self.config.patch_size
        x = self.patch_embedding(pixel_values)
        b = x.shape[0]
        gh, gw = pixel_values.shape[1] // p, pixel_values.shape[2] // p
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + interpolate_pos(self.position_embedding, gh, gw).to(x.dtype)

    def forward(self, pixel_values, output_hidden_states: bool = False, layers=None):
        x = self.embed(pixel_values)
        hiddens = [x]
        for layer in self.layers[:layers]:
            x = layer(x)
            hiddens.append(x)
        return x, x[:, 0], (hiddens if output_hidden_states else None)
