"""SD1.5 under a ControlNet or a T2I-Adapter at their published widths, with
seeded random weights, and the launch walks of their pipelines and trainers.

`SD15_CONTROLNET` is lllyasviel/sd-controlnet-canny's config.json (the SD1.5
encoder's widths and heads, conditioning_embedding_out_channels (16, 32, 96,
256), a 3-channel control image at 8x the latents' side; 361 M parameters);
`SD15_T2I_ADAPTER` is TencentARC/t2iadapter_canny_sd15v2's widths (channels
320-1280, 2 res blocks, downscale 8) with `in_channels` 3, as the JAX
package's trainer builds its adapter. No checkpoint is read: `core.init`
fills every weight from a seeded generator, the ControlNet's zero-initialised
convs too, so that its residuals are not zero.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from ..core.init import build_random
from ..models.layers import n_layer_norms, set_compute_dtype
from ..ops.attention import use_flash
from .models import ControlNetConfig, ControlNetModel, T2IAdapter, T2IAdapterConfig
from .models.resnet import n_group_norms
from .sd15 import SD15_UNET, attention_sites, expected_launches_sd15, keyed, train_walk

SD15_CONTROLNET = dict(
    {k: v for k, v in SD15_UNET.items() if k not in ("sample_size", "out_channels",
                                                       "up_block_types")},
    conditioning_channels=3, conditioning_embedding_out_channels=(16, 32, 96, 256))
SD15_T2I_ADAPTER = dict(in_channels=3, channels=(320, 640, 1280, 1280), num_res_blocks=2,
                        downscale_factor=8)


def random_controlnet(device, dtype=torch.bfloat16, seed: int = 0, config: Dict = SD15_CONTROLNET,
                      compute_dtype=None) -> ControlNetModel:
    """A ControlNet with every weight drawn on `device` from a seeded
    generator, in `dtype` (computing in `compute_dtype`, None: in `dtype`);
    feature-map weights in channels_last memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_random(lambda: ControlNetModel(ControlNetConfig.from_dict(config)),
                         device=device, dtype=dtype, generator=gen)
    return set_compute_dtype(model.to(memory_format=torch.channels_last), compute_dtype)


def random_t2i_adapter(device, dtype=torch.bfloat16, seed: int = 0,
                       config: Dict = SD15_T2I_ADAPTER, compute_dtype=None) -> T2IAdapter:
    """A full T2I-Adapter drawn on `device` from a seeded generator, as
    `random_controlnet`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_random(lambda: T2IAdapter(T2IAdapterConfig(**config)), device=device,
                         dtype=dtype, generator=gen)
    return set_compute_dtype(model.to(memory_format=torch.channels_last), compute_dtype)


def expected_launches_controlnet(pipe, height: int = 512, width: int = 512,
                                 num_inference_steps: int = 20,
                                 guidance_scale: float = 7.5) -> Dict:
    """Kernel launches of one single-prompt call of a
    StableDiffusionControlNetPipeline, keyed by wrapper name: the SD1.5
    pipeline's (`expected_launches_sd15`) and, every step, the ControlNet's
    on the CFG-doubled latents: its flash self-attentions (6 at 512 px: 2 at
    each head_dim 40, 80 and 160; the mid block's 64 tokens and the
    cross-attention take math) and its GroupNorms (B4). Under
    `flash_attention_by_dim`, B1 by the caller's head_dim."""
    out = expected_launches_sd15(pipe, height, width, num_inference_steps, guidance_scale)
    by_dim = Counter(out["flash_attention_by_dim"])
    cn, f = pipe.controlnet, pipe.vae_scale_factor
    rows, text_len = 2 if guidance_scale > 1.0 else 1, pipe.tokenizer.model_max_length
    for _, level, tf in attention_sites(cn):
        tokens = (height // f >> level) * (width // f >> level)
        for blk in tf.transformer_blocks:
            heads, hd = blk.attn1.num_heads, blk.attn1.head_dim
            q = (rows, tokens, heads, hd)
            n = num_inference_steps * (use_flash(q, q) + use_flash(q, (rows, text_len, heads, hd)))
            out["flash_attention"] += n
            by_dim[hd] += n
    out["group_norm"] += n_group_norms(cn) * num_inference_steps
    out["flash_attention_by_dim"] = dict(+by_dim)
    return out


def expected_launches_controlnet_train(unet, controlnet, batch: int, latent_hw: int,
                                       steps: int = 1, context_len: int = 77) -> Dict:
    """Kernel launches of `steps` steps of `tools.train_controlnet`'s loss,
    forward and backward, from walking the blocks (`sd15.train_walk`): every
    ControlNet attention trains (B15, B14); the frozen UNet's down blocks see
    no gradient (the residuals are added after them: B1's inference form),
    its mid and up blocks do (B15 and B14 produce dq / dk / dv through the
    frozen attention); every GroupNorm of both runs its forward (B4) once.
    Keys as `sd15.keyed` gives them."""
    walk = train_walk(controlnet, batch, latent_hw, steps, context_len)
    walk += train_walk(unet, batch, latent_hw, steps, context_len,
                       grad=lambda site: site[0] != "down")
    return keyed(walk)


def expected_launches_adapter_train(pipe, batch: int, resolution: int, steps: int = 1,
                                    prompts: int = 1) -> Dict:
    """Kernel launches of `tools.train_t2i_adapter.main` over `steps` steps
    at `batch` images of `resolution` px: the prompt once through the text
    tower (B10, and B1 where its attention takes flash), each step one
    batched encode by the VAE (its GroupNorms, B4, and its mid-block
    attention where flash takes it) and the frozen UNet's training walk, in
    which down block 0 sees no gradient (the first adapter feature is added
    after it: B1) and the later blocks do (B15, B14). Keys as `sd15.keyed`
    gives them. (A request of the adapter pipeline launches what SD1.5's
    does, `expected_launches_sd15`: the adapter's convs, ReLUs and average
    pools run none of the kernels.)"""
    f, text_len = pipe.vae_scale_factor, pipe.tokenizer.model_max_length
    walk = train_walk(pipe.unet, batch, resolution // f, steps, text_len,
                      grad=lambda site: site[0] != "down" or site[1] > 0)
    walk["group_norm"] += steps * n_group_norms(pipe.vae.encoder)
    walk["flash_attention"] += steps * pipe.vae.encode_flash_launches(resolution, resolution)
    walk["layer_norm"] += prompts * n_layer_norms(pipe.text_encoder)
    walk["flash_attention"] += prompts * pipe.text_encoder.text_model.flash_launches(text_len)
    return keyed(+walk)
