"""AutoencoderKL (port of paddlemix_tpu/diffusers/models/autoencoder_kl.py):
the Encoder with quant_conv, the diagonal Gaussian posterior, and the
Decoder with post_quant_conv. `encode` and `decode` take and return NHWC, as
the JAX package does.

The encoder is the JAX package's: its down-sampling convs pad one pixel on
every side (diffusers pads right and bottom only; ROADMAP lists it among the
reference's faults), and it stays unquantized.

`quant="a8w8_static"` quantizes the decoder's resnet and up-sample convs
(ops/quant.py); its conv_in, conv_out, post_quant_conv and attention stay
plain, as in the JAX package.

`from_pretrained` reads a `vae/` directory (flax- or torch-keyed weights
through `VAE_KEY_MAP`, core/modeling.py); `scaling_factor` comes from its
config (0.18215 for SD1.5, 0.13025 for SDXL, 1.5305 with `shift_factor`
0.0609 for SD3).

`use_quant_conv` / `use_post_quant_conv` are diffusers' config flags, true
by default, which is the JAX package's form (it always builds both 1x1
convs). Where one is false there is no such module and its step is the
identity. This departs from JAX (ROADMAP C.26): SD3's published VAE sets
both false and its file has neither conv, which JAX's non-strict read
leaves at their random init and the port's strict read would refuse.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import VAE_KEY_MAP
from ...ops.attention import use_flash
from .attention import AttentionBlock2D
from .resnet import Downsample2D, GroupNormAct, ResnetBlock2D, Upsample2D


@dataclasses.dataclass
class AutoencoderKLConfig(BaseConfig):
    model_type = "autoencoder_kl"
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
    use_quant_conv: bool = True  # false: no quant_conv, the encoder's moments as they are
    use_post_quant_conv: bool = True  # false: no post_quant_conv
    quant: Optional[str] = None  # "a8w8_static" or None: the decoder only

    @property
    def quantized(self) -> bool:
        if self.quant not in (None, "a8w8_static"):
            raise NotImplementedError(f"quant {self.quant!r}: only 'a8w8_static' is ported")
        return self.quant == "a8w8_static"


class DiagonalGaussian(NamedTuple):
    """The posterior: mean and log-variance (B, h, w, latent), NHWC."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * N(0, 1), the noise drawn from `generator` (on the
        mean's device), std from the log-variance clipped to [-30, 20]."""
        std = torch.exp(0.5 * self.logvar.clamp(-30.0, 20.0))
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I) per example, summed over (h, w, latent)."""
        logvar = self.logvar.clamp(-30.0, 20.0)
        return 0.5 * (self.mean ** 2 + logvar.exp() - 1.0 - logvar).sum(
            dim=tuple(range(1, self.mean.ndim)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers, add_downsample, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, groups=groups)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)]) if add_downsample \
            else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


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


class Encoder(nn.Module):
    """conv_in, the down blocks, the mid block (resnet, single-head
    attention, resnet), GroupNorm+SiLU (eps 1e-6), conv_out to 2 x latent
    channels (mean and log-variance)."""

    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        chans, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(DownEncoderBlock2D(prev, ch, cfg.layers_per_block,
                                                       add_downsample=i < len(chans) - 1,
                                                       groups=g))
            prev = ch
        self.mid_block = VAEMidBlock(chans[-1], cfg.mid_block_add_attention, g)
        self.conv_norm_out = GroupNormAct(chans[-1], g, eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


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
    flax_key_map = VAE_KEY_MAP  # its names -> the JAX AutoencoderKLModule's

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        c = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * c, 2 * c, 1) if config.use_quant_conv else None
        self.post_quant_conv = nn.Conv2d(c, c, 1) if config.use_post_quant_conv else None

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.conv_in.weight.dtype

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "AutoencoderKL":
        """The VAE of directory `path` (or its `subfolder`, e.g. "vae") on
        `device`, its parameters in `dtype` (the model computes in it),
        feature-map weights in channels_last memory."""
        from ...core.modeling import from_pretrained

        def build(config):
            return cls(config).to(memory_format=torch.channels_last)
        return from_pretrained(cls, AutoencoderKLConfig, cls.flax_key_map, path, device=device,
                               param_dtype=dtype, subfolder=subfolder, drop_unexpected=True,
                               build=build)

    def save_pretrained(self, directory: str):
        """config.json and flax-keyed model.safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory)

    def encode(self, x) -> DiagonalGaussian:
        """x: (B, H, W, C) NHWC pixels in [-1, 1] -> the posterior over
        (B, H/8, W/8, latent) latents (the model's dtype)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        moments = moments.permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z):
        """z: (B, h, w, latent) NHWC -> image (B, 8h, 8w, C) NHWC."""
        z = z.to(self.dtype).permute(0, 3, 1, 2)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        x = self.decoder(z)
        return x.permute(0, 2, 3, 1)

    def decode_flash_launches(self, h: int, w: int) -> int:
        """Flash launches of one batch-1 decode of (h, w) latents."""
        return _flash_launches(self.decoder, h * w)

    def encode_flash_launches(self, height: int, width: int) -> int:
        """Flash launches of one batch-1 encode of a (height, width) image:
        the mid block's attention over the last level's pixels."""
        f = 2 ** (len(self.config.block_out_channels) - 1)
        return _flash_launches(self.encoder, (height // f) * (width // f))


def _flash_launches(module, tokens: int) -> int:
    flash = 0
    for m in module.modules():
        if isinstance(m, AttentionBlock2D):
            q = (1, tokens, 1, m.to_q.out_features)
            flash += use_flash(q, q)
    return flash
