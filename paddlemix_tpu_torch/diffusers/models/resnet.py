"""UNet / VAE resnet and up/down-sample blocks (port of
paddlemix_tpu/diffusers/models/resnet.py).

Feature maps are NCHW tensors in torch.channels_last memory format: the
memory is NHWC, so `x.permute(0, 2, 3, 1)` is a contiguous (B, H, W, C) view
that the channel-minor GroupNorm and int8 kernels read without a copy.

With `quant=True` the convs are static-a8w8 ops (ops/quant.py). Once their
scales are loaded, `ResnetBlock2D` runs each of its 3x3 convs as one fused
GroupNorm+SiLU+int8-conv call (B5), with the time embedding in conv1's
epilogue and the shortcut in conv2's; scales are recorded and loaded in the
order conv1, conv2, conv_shortcut, as the JAX block consumes them.
`time_emb_proj` stays a plain Linear, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...models.layers import Linear
from ...ops.fused_resnet import fused_gn_silu_conv3x3
from ...ops.norms import group_norm
from ...ops.quant import conv2d


def group_norm_nchw(x, weight, bias, groups: int, eps: float, act: str):
    """GroupNorm(+act) of an NCHW feature map through the channel-minor op."""
    y = group_norm(x.permute(0, 2, 3, 1).contiguous(), weight, bias, groups, eps, act)
    return y.permute(0, 3, 1, 2)


class GroupNormAct(nn.Module):
    """GroupNorm with fused activation ("silu" or "none"); nn.GroupNorm's
    weight/bias parameter names."""

    def __init__(self, num_channels: int, groups: int = 32, eps: float = 1e-5,
                 act: str = "silu"):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm_nchw(x, self.weight, self.bias, self.groups, self.eps, self.act)


def n_group_norms(module) -> int:
    """GroupNorm modules (each one launch a forward); _GroupNorm32 is a GroupNormAct."""
    return sum(isinstance(m, GroupNormAct) for m in module.modules())


class ResnetBlock2D(nn.Module):
    """norm1+SiLU -> conv1 (+ time projection) -> norm2+SiLU -> conv2, plus the
    shortcut (a 1x1 conv when the width changes). GroupNorm eps 1e-5."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32, quant: bool = False):
        super().__init__()
        self.norm1 = GroupNormAct(in_channels, groups)
        self.conv1 = conv2d(quant, in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNormAct(out_channels, groups)
        self.conv2 = conv2d(quant, out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = conv2d(quant, in_channels, out_channels, 1) \
            if in_channels != out_channels else None

    @property
    def fused(self) -> bool:
        """Runs as two B5 calls: both 3x3 convs have their scales."""
        return getattr(self.conv1, "quantized", False) and self.conv2.quantized

    def _fused_forward(self, x, temb):
        def fused(inp, norm, conv, **epilogue):
            return fused_gn_silu_conv3x3(inp, norm.weight, norm.bias, norm.groups, norm.eps,
                                         conv.wq, conv.sw, conv.sx, conv.qbias, **epilogue)

        t = self.time_emb_proj(F.silu(temb)) if temb is not None else None
        h = fused(x.permute(0, 2, 3, 1).contiguous(), self.norm1, self.conv1, temb=t)
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        h = fused(h, self.norm2, self.conv2, residual=sc.permute(0, 2, 3, 1).contiguous())
        return h.permute(0, 3, 1, 2)

    def forward(self, x, temb=None):
        if self.fused:
            return self._fused_forward(x, temb)
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, quant: bool = False):
        super().__init__()
        self.conv = conv2d(quant, channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int, quant: bool = False):
        super().__init__()
        self.conv = conv2d(quant, channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
