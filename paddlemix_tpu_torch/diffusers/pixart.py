"""PixArt-XL-2-512x512 at its published widths, with seeded random weights,
and the launch walk of its pipeline.

`PIXART_XL_2_512` is PixArt-alpha/PixArt-XL-2-512x512's transformer (the
JAX `PixArtConfig` defaults: 28 blocks of 16 heads x 72 over 64 x 64 x 4
latents, patch 2, learned variance, 4,096-wide T5 captions, no
micro-conditions); the text encoder is T5 v1.1-XXL (SD3's third encoder's
widths, `sd3.SD3_TEXT_ENCODER_3`) over 120 caption tokens, the VAE is SD's
(sd-vae-ft-ema's widths, as SD1.5's), and the scheduler is DPM-Solver++ at
the JAX defaults (linear betas from 1e-4 to 2e-2, linspace spacing, order 2).
No checkpoint is read: `core.init` fills every weight from a seeded
generator (each `scale_shift_table` at std 0.02, as flax's init; T5's q
and relative-position table at transformers' T5 init). The JAX
package has no T5 tokenizer: `sd3.seeded_t5_tokenizer(length=120)` stands in.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from ..core.init import build_random
from ..models.t5 import T5Config, T5EncoderModel, T5LayerNorm
from ..ops.attention import use_flash
from .models import AutoencoderKL, AutoencoderKLConfig, PixArtConfig, PixArtTransformer2DModel
from .models.resnet import n_group_norms
from .pipelines import PixArtAlphaPipeline
from .schedulers import DPMSolverMultistepScheduler
from .sd3 import SD3_TEXT_ENCODER_3, seeded_t5_tokenizer
from .sd15 import SD15_VAE

PIXART_XL_2_512 = dict(sample_size=64, patch_size=2, in_channels=4, out_channels=8,
                       num_layers=28, num_attention_heads=16, attention_head_dim=72,
                       caption_channels=4096, use_additional_conditions=False)
PIXART_CAPTION_TOKENS = 120  # PixArt-alpha's T5 caption length


def random_pixart_pipeline(device, dtype=torch.bfloat16, seed: int = 0) -> PixArtAlphaPipeline:
    """The PixArt-alpha pipeline with weights drawn on `device` from one
    seeded generator in `dtype` (T5's norm scales fp32; the VAE's weights in
    channels_last memory)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    t5 = build_random(lambda: T5EncoderModel(T5Config(**SD3_TEXT_ENCODER_3)), **kw,
                      fp32_modules=(T5LayerNorm,))
    return PixArtAlphaPipeline(
        tokenizer=seeded_t5_tokenizer(seed, t5.config.vocab_size, length=PIXART_CAPTION_TOKENS),
        text_encoder=t5,
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**SD15_VAE)), **kw)
        .to(memory_format=torch.channels_last),
        transformer=build_random(
            lambda: PixArtTransformer2DModel(PixArtConfig(**PIXART_XL_2_512)), **kw),
        scheduler=DPMSolverMultistepScheduler())


def expected_launches_pixart(pipe: PixArtAlphaPipeline, prompts: int = 1,
                             num_inference_steps: int = 20,
                             guidance_scale: float = 4.5) -> Dict[str, int]:
    """Kernel launches of one pipeline call over `prompts` prompts, keyed by
    wrapper name: each step every block's self-attention and cross-attention
    over the caption where `use_flash` takes them (at 512 px the 1,024-token
    self-attention is flash, the 120-key cross-attention math); T5's RMSNorms
    (B11) for the prompts and, with guidance, the negative prompts (encoded
    apart; T5's attention has a bias, so math); one VAE decode (B4; its
    mid-block attention is 512 wide, math)."""
    tf, f = pipe.transformer, pipe.vae_scale_factor
    cfg = tf.config
    rows = prompts * (2 if guidance_scale > 1.0 else 1)
    caption = len(pipe.tokenizer([""])["input_ids"][0])
    tokens = (cfg.sample_size // cfg.patch_size) ** 2
    q = (rows, tokens, cfg.num_attention_heads, cfg.attention_head_dim)
    kv = (rows, caption, cfg.num_attention_heads, cfg.attention_head_dim)
    out = Counter(flash_attention=num_inference_steps * cfg.num_layers
                  * (use_flash(q, q) + use_flash(q, kv)))
    encodes = 2 if guidance_scale > 1.0 else 1
    out["rms_norm"] += encodes * sum(isinstance(m, T5LayerNorm)
                                     for m in pipe.text_encoder.modules())
    out["group_norm"] += n_group_norms(pipe.vae.decoder)
    out["flash_attention"] += pipe.vae.decode_flash_launches(cfg.sample_size, cfg.sample_size)
    return dict(out)
