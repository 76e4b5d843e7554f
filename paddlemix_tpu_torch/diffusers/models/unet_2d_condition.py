"""UNet2DConditionModel for SD / SDXL (port of
paddlemix_tpu/diffusers/models/unet_2d_condition.py).

The public forward takes and returns NHWC latents, as the JAX package does;
inside, feature maps are NCHW in channels_last memory. Parameter names are
diffusers'. The ControlNet, T2I-Adapter, GLIGEN, IP-Adapter and reference
hooks of the JAX module are not ported.

Mixed precision as flax's module `dtype=` gives it:
`models.layers.set_compute_dtype(unet, torch.bfloat16)` computes in bf16 over
parameters kept in their own dtype (fp32 masters for training): every conv, Linear and
transformer LayerNorm casts at its call, GroupNorm takes fp32 weights beside
bf16 rows, and the timestep embedding is cast as JAX casts it.

`quant="a8w8_static"` makes every resnet, transformer and up/down-sample conv
or projection a static a8w8 op (ops/quant.py); conv_in, conv_out, the time
and add embeddings and time_emb_proj stay plain, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ...models.layers import Conv2d
from .attention import Transformer2DModel
from .embeddings import TimestepEmbedding, Timesteps
from .resnet import Downsample2D, GroupNormAct, ResnetBlock2D, Upsample2D


@dataclasses.dataclass
class UNet2DConditionConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    num_attention_heads: Optional[Union[int, Tuple[int, ...]]] = None
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    addition_embed_type: Optional[str] = None  # "text_time" (SDXL)
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None
    quant: Optional[str] = None  # "a8w8_static" or None

    @property
    def quantized(self) -> bool:
        if self.quant not in (None, "a8w8_static"):
            raise NotImplementedError(f"quant {self.quant!r}: only 'a8w8_static' is ported")
        return self.quant == "a8w8_static"

    def _per_block(self, v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * len(self.block_out_channels)

    @property
    def heads_per_block(self):
        # diffusers quirk: attention_head_dim historically stored the head count
        if self.num_attention_heads is not None:
            return self._per_block(self.num_attention_heads)
        return self._per_block(self.attention_head_dim)

    @property
    def tf_layers_per_block(self):
        return self._per_block(self.transformer_layers_per_block)


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers, num_heads,
                 tf_layers, cross_dim, use_linear_projection, add_downsample=True, groups=32,
                 quant=False):
        super().__init__()
        head_dim = out_channels // num_heads
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups, quant) for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, num_heads, head_dim, cross_dim, tf_layers,
                               use_linear_projection, groups, quant) for _ in range(num_layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels, quant)]) \
            if add_downsample else None

    def forward(self, x, temb, context):
        outputs = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), context)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class DownBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers,
                 add_downsample=True, groups=32, quant=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups, quant) for i in range(num_layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels, quant)]) \
            if add_downsample else None

    def forward(self, x, temb, context=None):
        outputs = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, channels, temb_channels, num_heads, tf_layers, cross_dim,
                 use_linear_projection, groups=32, quant=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, groups, quant) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, num_heads, channels // num_heads, cross_dim, tf_layers,
                               use_linear_projection, groups, quant)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock2D(nn.Module):
    """`resnet_in_channels[i]` is the width after concatenating skip i."""

    def __init__(self, resnet_in_channels, out_channels, temb_channels, num_heads, tf_layers,
                 cross_dim, use_linear_projection, add_upsample=True, groups=32, quant=False):
        super().__init__()
        head_dim = out_channels // num_heads
        self.resnets = nn.ModuleList([ResnetBlock2D(c, out_channels, temb_channels, groups, quant)
                                      for c in resnet_in_channels])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, num_heads, head_dim, cross_dim, tf_layers,
                               use_linear_projection, groups, quant) for _ in resnet_in_channels])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels, quant)]) if add_upsample \
            else None

    def forward(self, x, skips: List[torch.Tensor], temb, context):
        for resnet, attn, skip in zip(self.resnets, self.attentions, skips):
            x = attn(resnet(torch.cat([x, skip], dim=1), temb), context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock2D(nn.Module):
    def __init__(self, resnet_in_channels, out_channels, temb_channels, add_upsample=True,
                 groups=32, quant=False):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, out_channels, temb_channels, groups, quant)
                                      for c in resnet_in_channels])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels, quant)]) if add_upsample \
            else None

    def forward(self, x, skips: List[torch.Tensor], temb, context=None):
        for resnet, skip in zip(self.resnets, skips):
            x = resnet(torch.cat([x, skip], dim=1), temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DConditionModel(nn.Module):
    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'

    def __init__(self, config: UNet2DConditionConfig):
        super().__init__()
        cfg = self.config = config
        if not isinstance(cfg.cross_attention_dim, int):
            raise NotImplementedError("per-block cross_attention_dim is not ported")
        chans, groups = tuple(cfg.block_out_channels), cfg.norm_num_groups
        heads, tf_layers = cfg.heads_per_block, cfg.tf_layers_per_block
        ctx, linear, q = cfg.cross_attention_dim, cfg.use_linear_projection, cfg.quantized
        temb = chans[0] * 4
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_proj = Timesteps(chans[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        if cfg.addition_embed_type == "text_time":
            self.add_time_proj = Timesteps(cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                           cfg.freq_shift)
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb)
        elif cfg.addition_embed_type is not None:
            raise NotImplementedError(f"addition_embed_type {cfg.addition_embed_type!r}")

        # widths of the skip tensors, in the order the down path makes them
        skip_chans = [chans[0]]
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, kind in enumerate(cfg.down_block_types):
            last = i == len(cfg.down_block_types) - 1
            if kind == "CrossAttnDownBlock2D":
                blk = CrossAttnDownBlock2D(prev, chans[i], temb, cfg.layers_per_block, heads[i],
                                           tf_layers[i], ctx, linear, not last, groups, q)
            elif kind == "DownBlock2D":
                blk = DownBlock2D(prev, chans[i], temb, cfg.layers_per_block, not last, groups, q)
            else:
                raise NotImplementedError(f"down block {kind!r}")
            self.down_blocks.append(blk)
            skip_chans += [chans[i]] * (cfg.layers_per_block + (not last))
            prev = chans[i]

        self.mid_block = UNetMidBlock2DCrossAttn(chans[-1], temb, heads[-1], tf_layers[-1], ctx,
                                                 linear, groups, q)

        self.up_blocks = nn.ModuleList()
        n = len(chans)
        for i, kind in enumerate(cfg.up_block_types):
            j = n - 1 - i  # matching down level
            last = i == len(cfg.up_block_types) - 1
            in_chans = []
            for _ in range(cfg.layers_per_block + 1):
                in_chans.append(prev + skip_chans.pop())
                prev = chans[j]
            if kind == "CrossAttnUpBlock2D":
                blk = CrossAttnUpBlock2D(in_chans, chans[j], temb, heads[j], tf_layers[j], ctx,
                                         linear, not last, groups, q)
            elif kind == "UpBlock2D":
                blk = UpBlock2D(in_chans, chans[j], temb, not last, groups, q)
            else:
                raise NotImplementedError(f"up block {kind!r}")
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNormAct(chans[0], groups, eps=1e-5, act="silu")
        self.conv_out = Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the model computes in (flax's module dtype)."""
        return self.compute_dtype or self.conv_in.weight.dtype

    def forward(self, sample, timestep, encoder_hidden_states, added_cond_kwargs=None):
        """sample: (B, H, W, C_in) NHWC; returns (B, H, W, C_out) NHWC."""
        cfg, dtype = self.config, self.dtype
        b = sample.shape[0]
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(b)
        emb = self.time_embedding(self.time_proj(timestep).to(dtype))
        if cfg.addition_embed_type == "text_time":
            text_embeds = added_cond_kwargs["text_embeds"]
            time_embeds = self.add_time_proj(added_cond_kwargs["time_ids"].reshape(-1))
            add_embeds = torch.cat([text_embeds.float(),
                                    time_embeds.reshape(text_embeds.shape[0], -1)], dim=-1)
            emb = emb + self.add_embedding(add_embeds.to(dtype))
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [x]
        for blk in self.down_blocks:
            x, outs = blk(x, emb, context)
            skips.extend(outs)
        x = self.mid_block(x, emb, context)
        for blk in self.up_blocks:
            block_skips = [skips.pop() for _ in blk.resnets]
            x = blk(x, block_skips, emb, context)
        x = self.conv_out(self.conv_norm_out(x))
        return x.permute(0, 2, 3, 1)
