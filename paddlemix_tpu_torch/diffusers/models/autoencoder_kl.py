"""AutoencoderKL decoder (port of paddlemix_tpu/diffusers/models/autoencoder_kl.py).

Only the decode path is ported (post_quant_conv + Decoder); the encoder
comes with img2img. `decode` takes and returns NHWC, as the JAX package does.

`quant="a8w8_static"` quantizes the decoder's resnet and up-sample convs
(ops/quant.py); its conv_in, conv_out, post_quant_conv and attention stay
plain, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.attention import use_flash
from .attention import AttentionBlock2D
from .resnet import GroupNormAct, ResnetBlock2D, Upsample2D


@dataclasses.dataclass
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",) * 4
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",) * 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215
    shift_factor: Optional[float] = None
    mid_block_add_attention: bool = True
    quant: Optional[str] = None  # "a8w8_static" or None: the decoder only

    @property
    def quantized(self) -> bool:
        if self.quant not in (None, "a8w8_static"):
            raise NotImplementedError(f"quant {self.quant!r}: only 'a8w8_static' is ported")
        return self.quant == "a8w8_static"


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers, add_upsample, groups=32,
                 quant=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, groups=groups,
                          quant=quant) for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels, quant)]) if add_upsample \
            else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class VAEMidBlock(nn.Module):
    def __init__(self, channels, add_attention, groups=32, quant=False):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups=groups, quant=quant)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels, groups)]) \
            if add_attention else None

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        rev, g, q = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups, cfg.quantized
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], cfg.mid_block_add_attention, g, q)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            self.up_blocks.append(UpDecoderBlock2D(prev, ch, cfg.layers_per_block + 1,
                                                   add_upsample=i < len(rev) - 1, groups=g,
                                                   quant=q))
            prev = ch
        self.conv_norm_out = GroupNormAct(rev[-1], g, eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def decode(self, z):
        """z: (B, h, w, latent) NHWC -> image (B, 8h, 8w, C) NHWC."""
        x = self.decoder(self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)

    def decode_flash_launches(self, h: int, w: int) -> int:
        """Flash launches of one batch-1 decode of (h, w) latents."""
        flash = 0
        for m in self.decoder.modules():
            if isinstance(m, AttentionBlock2D):
                q = (1, h * w, 1, m.to_q.out_features)
                flash += use_flash(q, q)
        return flash
