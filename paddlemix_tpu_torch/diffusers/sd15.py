"""Stable Diffusion 1.5 at its published widths, with seeded random weights.

The widths are those of the public runwayml/stable-diffusion-v1-5 configs
(unet, vae, text_encoder = CLIP ViT-L/14 text, scheduler = PNDM with
skip_prk_steps), which the JAX package carries as `SD15_UNET_CONFIG`,
`SD15_VAE_CONFIG` and its single-file loader's text config and scheduler
(paddlemix_tpu/diffusers/single_file.py); the dicts below are the port's own
copies. The UNet's `attention_head_dim=8` is a head count (the diffusers
quirk), so its transformer blocks run 8 heads of 40, 80 and 160 over 320,
640 and 1280 channels, with 1x1-conv projections in and out. No checkpoint
is read: weights come from a torch.Generator (core.init), made on the target
device. `load_flax_sd15_pipeline` carries a JAX SD1.5 pipeline's parameters
over.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.convert import (
    CLIP_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from ..core.init import build_random
from ..models.clip import CLIPTextConfig, CLIPTextModel, CLIPTokenizer
from ..models.clip.tokenizer import byte_level_tokenizer
from .models import AutoencoderKL, AutoencoderKLConfig, UNet2DConditionConfig, UNet2DConditionModel
from .pipelines import StableDiffusionPipeline
from .schedulers import PNDMScheduler
from .sdxl import expected_launches, flash_launches_by_dim

SD15_UNET = dict(
    sample_size=64, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D"),
    block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
    cross_attention_dim=768, attention_head_dim=8,
)
SD15_VAE = dict(
    sample_size=512, in_channels=3, out_channels=3, latent_channels=4,
    down_block_types=("DownEncoderBlock2D",) * 4, up_block_types=("UpDecoderBlock2D",) * 4,
    block_out_channels=(128, 256, 512, 512), layers_per_block=2, scaling_factor=0.18215,
)
SD15_TEXT_ENCODER = dict(  # CLIP ViT-L/14 text
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, hidden_act="quick_gelu")
SD15_SCHEDULER = dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
                      skip_prk_steps=True)


def random_sd15_pipeline(device, dtype=torch.bfloat16, seed: int = 0, unet: Dict = SD15_UNET,
                         vae: Dict = SD15_VAE, text_encoder: Dict = SD15_TEXT_ENCODER,
                         tokenizer: Optional[CLIPTokenizer] = None) -> StableDiffusionPipeline:
    """An SD1.5 pipeline with weights drawn on `device` from one seeded
    generator. Feature-map weights are put in channels_last memory."""
    tok = tokenizer or byte_level_tokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    te_cfg = CLIPTextConfig(**text_encoder, eos_token_id=tok.eos_token_id,
                            max_position_embeddings=tok.model_max_length)
    return StableDiffusionPipeline(
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**vae)), **kw)
        .to(memory_format=torch.channels_last),
        text_encoder=build_random(lambda: CLIPTextModel(te_cfg), **kw),
        tokenizer=tok,
        unet=build_random(lambda: UNet2DConditionModel(UNet2DConditionConfig(**unet)), **kw)
        .to(memory_format=torch.channels_last),
        scheduler=PNDMScheduler(**SD15_SCHEDULER))


def expected_launches_sd15(pipe: StableDiffusionPipeline, height: int = 512, width: int = 512,
                           num_inference_steps: int = 50, guidance_scale: float = 7.5) -> Dict:
    """Kernel launches one single-prompt call should make, keyed by wrapper
    name, from walking the blocks (`sdxl.expected_launches`), and under
    `flash_attention_by_dim` the flash launches by the caller's head_dim
    (the counter `flash_attention.launches_by_dim`). At 512 px the 15
    self-attentions of a forward over 4,096, 1,024 and 256 tokens take flash
    (5 each at head_dim 40, 80 and 160); the mid block's 64 tokens, the
    77-token cross-attention, the causal text tower and the VAE's 512-wide
    head go to math."""
    out = expected_launches(pipe, height, width, num_inference_steps, guidance_scale)
    out["flash_attention_by_dim"] = dict(flash_launches_by_dim(
        pipe, height, width, num_inference_steps, guidance_scale))
    return out


# pipeline component -> key map of the JAX package's model class
_FLAX_KEY_MAPS = {"unet": UNET_KEY_MAP, "vae": VAE_KEY_MAP, "text_encoder": CLIP_KEY_MAP}


def load_flax_sd15_pipeline(pipe: StableDiffusionPipeline, params: Dict[str, dict]
                            ) -> StableDiffusionPipeline:
    """Load a JAX SD1.5 pipeline's parameters into the port's `pipe`: `params`
    maps `unet`, `vae` and `text_encoder` to their flax params (nested dicts
    of arrays). The port's VAE is the decoder only, so the JAX VAE's
    `encoder` and `quant_conv` are dropped; every other key on both sides
    must be consumed (see `flax_to_torch_state_dict`). Returns `pipe`."""
    for name, key_map in _FLAX_KEY_MAPS.items():
        if name not in params:
            raise KeyError(f"load_flax_sd15_pipeline: no parameters for component {name!r}")
        module = getattr(pipe, name)
        tree = params[name]
        if name == "vae":
            tree = {k: v for k, v in tree.items() if k not in ("encoder", "quant_conv")}
        module.load_state_dict(flax_to_torch_state_dict(flatten_flax(tree), module, key_map))
    return pipe
