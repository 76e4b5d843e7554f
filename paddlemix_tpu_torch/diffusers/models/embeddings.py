"""Timestep, label and patch embeddings (port of
paddlemix_tpu/diffusers/models/embeddings.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...models.layers import Conv2d, Linear


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0) -> torch.Tensor:
    """timesteps: (B,) -> (B, embedding_dim) fp32 sinusoids (even embedding_dim),
    diffusers semantics with max period 10000."""
    half = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32,
                                               device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class Timesteps(nn.Module):
    def __init__(self, num_channels: int, flip_sin_to_cos: bool = True,
                 downscale_freq_shift: float = 0.0):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift

    def forward(self, timesteps):
        return get_timestep_embedding(timesteps, self.num_channels,
                                      flip_sin_to_cos=self.flip_sin_to_cos,
                                      downscale_freq_shift=self.downscale_freq_shift)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


def get_1d_sincos_pos_embed(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """(N,) positions -> (N, embed_dim) fp32 [sin, cos] with max period 10000."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = pos.reshape(-1).float()[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def get_2d_sincos_pos_embed(embed_dim: int, gh: int, gw: int, base_size: int = 16,
                            device=None) -> torch.Tensor:
    """(gh * gw, embed_dim) fp32 table, rows in row-major (h, w) order,
    computed for the grid (not cropped from a larger one). The first half
    encodes the W coordinate and the second the H coordinate: the MAE layout
    that diffusers' checkpoints were trained with."""
    grid_h = torch.arange(gh, dtype=torch.float32, device=device) / (gh / base_size)
    grid_w = torch.arange(gw, dtype=torch.float32, device=device) / (gw / base_size)
    mesh_w, mesh_h = torch.meshgrid(grid_w, grid_h, indexing="xy")  # (gh, gw) each
    return torch.cat([get_1d_sincos_pos_embed(embed_dim // 2, mesh_w),
                      get_1d_sincos_pos_embed(embed_dim // 2, mesh_h)], dim=-1)


class LabelEmbedding(nn.Module):
    """Class labels -> (B, hidden) vectors, with classifier-free guidance's
    null class (port of `LabelEmbedding`, DiT's `y_embedder`): with
    `dropout_prob` > 0 the table has `num_classes + 1` rows, the last the
    null class. `force_drop_ids` (B,) bool replaces those labels by the null
    class; else, given a torch.Generator, each label is dropped with
    probability `dropout_prob` (JAX's `rng` draw, from torch's generator)."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(num_classes + (dropout_prob > 0), hidden_size)

    def forward(self, labels, force_drop_ids=None, generator: Optional[torch.Generator] = None):
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids.bool(), self.num_classes, labels)
        elif generator is not None and self.dropout_prob > 0:
            drop = torch.rand(labels.shape, generator=generator,
                              device=labels.device) < self.dropout_prob
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class PatchEmbed2D(nn.Module):
    """DiT/SD3 latent patchify: (B, H, W, C) NHWC -> (B, HW/p^2, D) tokens in
    row-major order, plus the 2D sincos position table of the grid (port of
    `PatchEmbed2D`), made on the latent's device at each call. The table is
    scaled to a grid side of `base_size`, or with None to the input's own
    (JAX's default, which PixArt takes)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 base_size: Optional[int]):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.base_size = base_size
        self.proj = Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, latent):
        b, h, w, _ = latent.shape
        p = self.patch_size
        x = self.proj(latent.permute(0, 3, 1, 2).to(self.proj.weight.dtype))
        x = x.flatten(2).transpose(1, 2)
        pos = get_2d_sincos_pos_embed(self.embed_dim, h // p, w // p, self.base_size or h // p,
                                      device=x.device)
        return x + pos.to(x.dtype)[None]
