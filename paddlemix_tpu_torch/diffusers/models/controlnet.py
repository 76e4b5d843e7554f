"""ControlNetModel (port of paddlemix_tpu/diffusers/models/controlnet.py):
the UNet's encoder half (conv_in, the time embedding and SDXL's text_time
addition where the config has it, the down blocks and the mid block, the
port's own block classes) with a conditioning-image embedder added after
conv_in, and a zero-initialised 1x1 conv a skip and one after the mid block
whose outputs, times `conditioning_scale`, are the residuals the UNet adds.

The public forward is JAX's: NHWC latents and an NHWC control image at
2^(len(conditioning_embedding_out_channels) - 1) times the latents' side in,
NHWC residuals out; inside, feature maps are NCHW in channels_last memory, as
in the UNet. Parameter names are diffusers'; `CONTROLNET_KEY_MAP` maps them to
the JAX module's flax names, so `from_pretrained` reads a `controlnet/`
directory written by either package or by diffusers, and `save_pretrained`
writes what the JAX package writes.

The JAX config extends the UNet's and drops the keys it has no field for.
Two of diffusers' ControlNet options would then compute something else
without a word: `global_pool_conditions` (the residuals averaged over space)
and `controlnet_conditioning_channel_order` "bgr" (the control image's
channels reversed). The port refuses both by name (ROADMAP C.30).
`gradient_checkpointing`, which JAX's ControlNet ignores, recomputes each
block in the backward as the UNet does: the same numbers in less memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.convert import CONTROLNET_KEY_MAP
from ...models.layers import Conv2d
from .unet_2d_condition import (
    UNet2DConditionConfig,
    UNetMidBlock2DCrossAttn,
    _add,
    _called,
    _channels_last,
    _checkpointed,
    encoder_blocks,
    input_embeddings,
    text_time_embedding,
)

# diffusers' ControlNet options that JAX drops unread, at the values that
# leave the computation as JAX does it (another value is refused, naming it)
_DROPPED_BY_JAX = dict(global_pool_conditions=False, controlnet_conditioning_channel_order="rgb")


@dataclasses.dataclass
class ControlNetConfig(UNet2DConditionConfig):
    model_type = "controlnet"
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @classmethod
    def from_dict(cls, data, **overrides):
        data = dict(data, **overrides)
        refused = {k: data[k] for k, v in _DROPPED_BY_JAX.items() if k in data and data[k] != v}
        if refused:
            raise NotImplementedError(f"ControlNetConfig: {refused} would be dropped unread by "
                                      f"the JAX package and computed as {_DROPPED_BY_JAX}; the "
                                      f"port refuses them")
        return super().from_dict(data)


class ControlNetConditioningEmbedding(nn.Module):
    """The control image (full resolution) down to the latents' grid:
    conv_in, SiLU, then per width step a 3x3 conv and SiLU and a stride-2 3x3
    conv (padding 1 on each side) and SiLU, then the zero-initialised
    conv_out."""

    def __init__(self, in_channels: int, out_channels: int, block_channels: Tuple[int, ...]):
        super().__init__()
        self.conv_in = Conv2d(in_channels, block_channels[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(block_channels, block_channels[1:]):
            self.blocks.append(Conv2d(c_in, c_in, 3, padding=1))
            self.blocks.append(Conv2d(c_in, c_out, 3, stride=2, padding=1))
        self.conv_out = Conv2d(block_channels[-1], out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


def _zero_conv(channels: int) -> Conv2d:
    conv = Conv2d(channels, channels, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ControlNetModel(nn.Module):
    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'
    flax_key_map = CONTROLNET_KEY_MAP  # its names -> the JAX ControlNetModule's

    def __init__(self, config: ControlNetConfig):
        super().__init__()
        cfg = self.config = config
        if not isinstance(cfg.cross_attention_dim, int):
            raise NotImplementedError("per-block cross_attention_dim is not ported")
        chans = tuple(cfg.block_out_channels)
        temb = input_embeddings(self, cfg)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.conditioning_channels, chans[0], tuple(cfg.conditioning_embedding_out_channels))
        # the JAX ControlNet builds its blocks without the UNet's quant
        self.down_blocks, skip_chans = encoder_blocks(cfg, temb, False)
        self.mid_block = UNetMidBlock2DCrossAttn(
            chans[-1], temb, cfg.heads_per_block[-1], cfg.tf_layers_per_block[-1],
            cfg.cross_attention_dim, cfg.use_linear_projection, cfg.norm_num_groups, False)
        self.controlnet_down_blocks = nn.ModuleList([_zero_conv(c) for c in skip_chans])
        self.controlnet_mid_block = _zero_conv(chans[-1])

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the model computes in (flax's module dtype)."""
        return self.compute_dtype or self.conv_in.weight.dtype

    @property
    def cond_scale_factor(self) -> int:
        """The control image's side over the latents' side."""
        return 2 ** (len(self.config.conditioning_embedding_out_channels) - 1)

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "ControlNetModel":
        """The ControlNet of directory `path` (or its `subfolder`, e.g.
        "controlnet") on `device`, its parameters in `dtype`, feature-map
        weights in channels_last memory; flax- or diffusers-keyed weights."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, ControlNetConfig, cls.flax_key_map, path, device=device,
                               param_dtype=dtype, subfolder=subfolder, drop_unexpected=True,
                               build=_channels_last(cls))

    def save_pretrained(self, directory: str):
        """config.json and flax-keyed model.safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory)

    def forward(self, sample, timestep, encoder_hidden_states, controlnet_cond,
                conditioning_scale: float = 1.0, added_cond_kwargs=None):
        """sample: (B, h, w, C_in) NHWC latents; controlnet_cond: (B, h f, w f,
        conditioning_channels) NHWC, f = `cond_scale_factor`. Returns (the
        residuals of the skips, NHWC, conv_in's first; the mid block's),
        each times `conditioning_scale`."""
        cfg, dtype = self.config, self.dtype
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(sample.shape[0])
        emb = self.time_embedding(self.time_proj(timestep).to(dtype))
        if cfg.addition_embed_type == "text_time" and added_cond_kwargs is not None:
            emb = emb + text_time_embedding(self, added_cond_kwargs)
        context = encoder_hidden_states.to(dtype)
        run = _checkpointed if cfg.gradient_checkpointing and torch.is_grad_enabled() else _called

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        x = _add(x, self.controlnet_cond_embedding(controlnet_cond.to(dtype).permute(0, 3, 1, 2)))
        skips = [x]
        for blk in self.down_blocks:
            x, outs = run(blk, x, emb, context, None)
            skips.extend(outs)
        x = run(self.mid_block, x, emb, context)
        down = tuple((conv(s) * conditioning_scale).permute(0, 2, 3, 1)
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        mid = (self.controlnet_mid_block(x) * conditioning_scale).permute(0, 2, 3, 1)
        return down, mid
