"""DiT-XL/2-256 at its published widths, with seeded random weights, and the
launch walks of its pipeline and trainer.

`DIT_XL_2_256` is facebook/DiT-XL-2-256's transformer (the JAX `DiTConfig`
defaults: 28 blocks of 16 heads x 72, patch 2 over 32 x 32 x 4 latents,
learned sigma, 1,000 classes), the VAE is SD's (sd-vae-ft-ema's widths, as
SD1.5's), and the schedulers run DiT's training schedule: linear betas from
1e-4 to 2e-2 over 1,000 steps. No checkpoint is read: `core.init` fills every
weight from a seeded generator. JAX zero-initialises `adaLN_modulation` and
`final_adaLN` (adaLN-zero): with zero gates every block is the identity and
an agree of the kernels against their plain versions could not fail, so the
seeded builders draw those Linears too; `adaln_zero=True` keeps JAX's init
(the trainer's `main` builds so).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from ..core.init import build_random
from ..models.layers import set_compute_dtype
from ..ops.attention import use_flash
from .models import AutoencoderKL, AutoencoderKLConfig, DiTConfig, DiTModel
from .models.resnet import n_group_norms
from .pipelines import DiTPipeline
from .schedulers import DDIMScheduler
from .sd15 import SD15_VAE

DIT_XL_2_256 = dict(sample_size=32, patch_size=2, in_channels=4, out_channels=8,
                    hidden_size=1152, num_layers=28, num_attention_heads=16, mlp_ratio=4.0,
                    num_classes=1000, class_dropout_prob=0.1)
DIT_SCHEDULER = dict(num_train_timesteps=1000, beta_schedule="linear", beta_start=1e-4,
                     beta_end=0.02)


def random_dit(device, dtype=torch.bfloat16, seed: int = 0, config: Dict = DIT_XL_2_256,
               compute_dtype=None, adaln_zero: bool = False) -> DiTModel:
    """A DiT with every weight drawn on `device` from a seeded generator, in
    `dtype` (computing in `compute_dtype`, None: in `dtype`); with
    `adaln_zero` the modulation Linears are zeroed after, as JAX inits them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_random(lambda: DiTModel(DiTConfig(**config)), device=device, dtype=dtype,
                         generator=gen)
    if adaln_zero:
        with torch.no_grad():
            for lin in [blk.adaLN_modulation for blk in model.blocks] + [model.final_adaLN]:
                lin.weight.zero_()
                lin.bias.zero_()
    return set_compute_dtype(model, compute_dtype)


def random_dit_pipeline(device, dtype=torch.bfloat16, seed: int = 0) -> DiTPipeline:
    """DiT and the SD VAE drawn on `device` from one seeded generator (the
    VAE's weights in channels_last memory), with DDIM at DiT's schedule (any
    ported scheduler can take its place)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    return DiTPipeline(
        transformer=build_random(lambda: DiTModel(DiTConfig(**DIT_XL_2_256)), **kw),
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**SD15_VAE)), **kw)
        .to(memory_format=torch.channels_last),
        scheduler=DDIMScheduler(**DIT_SCHEDULER))


def dit_forward_launches(model: DiTModel, batch: int) -> Counter:
    """Kernel launches of one inference forward at `batch`, keyed by wrapper
    name: two adaLN (B12) a block and the final one, and each block's
    self-attention where `use_flash` takes it (B1's inference form)."""
    cfg = model.config
    tokens = (cfg.sample_size // cfg.patch_size) ** 2
    out = Counter(adaptive_layer_norm=2 * cfg.num_layers + 1)
    for blk in model.blocks:
        q = (batch, tokens, blk.num_heads, blk.head_dim)
        out["flash_attention"] += use_flash(q, q)
    return out


def expected_launches_dit(pipe: DiTPipeline, labels: int, num_inference_steps: int = 25,
                          guidance_scale: float = 4.0) -> Dict[str, int]:
    """Kernel launches of one pipeline call over `labels` class labels, keyed
    by wrapper name: the transformer's forward each step on the CFG-doubled
    batch, then one VAE decode (its GroupNorms, B4; its mid-block attention
    is 512 wide, math)."""
    rows = labels * (2 if guidance_scale > 1.0 else 1)
    out = Counter({k: v * num_inference_steps
                   for k, v in dit_forward_launches(pipe.transformer, rows).items()})
    side = pipe.transformer.config.sample_size
    out["group_norm"] += n_group_norms(pipe.vae.decoder)
    out["flash_attention"] += pipe.vae.decode_flash_launches(side, side)
    return dict(out)


def expected_launches_dit_train(model: DiTModel, batch: int, steps: int = 1) -> Dict[str, int]:
    """Kernel launches of `steps` training micro-batches of `batch` latents,
    keyed by wrapper name: each flash self-attention runs the lse forward
    (B15) and the two backward kernels (B14) once, each block two adaLN (B12)
    forwards (their backward is autograd of the plain version), the final
    adaLN one more. With gradient checkpointing every block's forward
    kernels run twice (the forward and the recompute)."""
    cfg = model.config
    runs = 2 if cfg.gradient_checkpointing else 1
    fwd = dit_forward_launches(model, batch)
    flash = fwd["flash_attention"]
    return {"adaptive_layer_norm": (2 * cfg.num_layers * runs + 1) * steps,
            "flash_fwd_lse": flash * runs * steps, "flash_bwd_dkv": flash * steps,
            "flash_bwd_dq": flash * steps}
