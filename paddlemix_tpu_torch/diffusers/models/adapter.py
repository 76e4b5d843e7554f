"""T2IAdapter, the full adapter (port of
paddlemix_tpu/diffusers/models/adapter.py): a small conv trunk that turns a
condition image (edges, sketch, depth) into one feature map a UNet down
block, which the UNet adds after that block's last resnet (and attention) as
its `down_intrablock_additional_residuals`.

The trunk: the image pixel-unshuffled by `downscale_factor`, conv_in (3x3),
then one block a width of `channels`: a 2x2 average pool from the second on,
a 1x1 `in_conv` where the width changes, and `num_res_blocks` x (3x3 conv,
ReLU, 1x1 conv, residual). The forward takes an NHWC image and returns NHWC
features; inside, maps are NCHW in channels_last memory.

`pixel_unshuffle` keeps the JAX package's channel order, (fh, fw, c): a
channel of the unshuffled map is (fh f + fw) C + c. diffusers'
`nn.PixelUnshuffle` orders them (c, fh, fw), so a published 3-channel
adapter's conv_in would see its inputs permuted; a 1-channel (canny) one is
the same either way (ROADMAP C.29). JAX's config has `adapter_type` and never
reads it: every type builds the full adapter. The port refuses the other
types by name (C.30). Parameter names are diffusers' FullAdapter's without
its `adapter.` prefix; `T2I_ADAPTER_KEY_MAP` maps them to the flax names,
which `from_pretrained` and `save_pretrained` use, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import T2I_ADAPTER_KEY_MAP
from ...models.layers import Conv2d
from .unet_2d_condition import _channels_last


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f f C), channels in JAX's (fh, fw, c) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


@dataclasses.dataclass
class T2IAdapterConfig(BaseConfig):
    model_type = "t2i_adapter"
    in_channels: int = 3
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_res_blocks: int = 2
    downscale_factor: int = 8
    adapter_type: str = "full_adapter"

    def __post_init__(self):
        if self.adapter_type != "full_adapter":
            raise NotImplementedError(f"T2IAdapterConfig: adapter_type {self.adapter_type!r}: "
                                      f"the JAX package builds the full adapter whatever the "
                                      f"type; the port ports 'full_adapter' alone")


class AdapterResnet(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = Conv2d(channels, channels, 3, padding=1)
        self.block2 = Conv2d(channels, channels, 1)

    def forward(self, x):
        return x + self.block2(F.relu(self.block1(x)))


class AdapterBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_res_blocks: int, down: bool):
        super().__init__()
        self.down = down
        self.in_conv = Conv2d(in_channels, channels, 1) if in_channels != channels else None
        self.resnets = nn.ModuleList([AdapterResnet(channels) for _ in range(num_res_blocks)])

    def forward(self, x):
        if self.down:
            x = F.avg_pool2d(x, 2)
        if self.in_conv is not None:
            x = self.in_conv(x)
        for resnet in self.resnets:
            x = resnet(x)
        return x


class T2IAdapter(nn.Module):
    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'
    flax_key_map = T2I_ADAPTER_KEY_MAP  # its names -> the JAX T2IAdapterModule's

    def __init__(self, config: T2IAdapterConfig):
        super().__init__()
        cfg = self.config = config
        chans = tuple(cfg.channels)
        self.conv_in = Conv2d(cfg.in_channels * cfg.downscale_factor ** 2, chans[0], 3, padding=1)
        self.body = nn.ModuleList([
            AdapterBlock(chans[max(i - 1, 0)], c, cfg.num_res_blocks, down=i > 0)
            for i, c in enumerate(chans)])

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.conv_in.weight.dtype

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "T2IAdapter":
        """The adapter of directory `path` (or its `subfolder`, e.g.
        "adapter") on `device`, its parameters in `dtype`."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, T2IAdapterConfig, cls.flax_key_map, path, device=device,
                               param_dtype=dtype, subfolder=subfolder, drop_unexpected=True,
                               build=_channels_last(cls))

    def save_pretrained(self, directory: str):
        """config.json and flax-keyed model.safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory)

    def forward(self, image) -> List[torch.Tensor]:
        """image: (B, H, W, in_channels) NHWC -> one NHWC feature map a
        block, at H / downscale_factor, then halved block by block."""
        x = pixel_unshuffle(image.to(self.dtype), self.config.downscale_factor)
        x = self.conv_in(x.permute(0, 3, 1, 2))
        feats = []
        for blk in self.body:
            x = blk(x)
            feats.append(x.permute(0, 2, 3, 1))
        return feats
