"""SD UNet fine-tuning (port of examples/train_text_to_image.py).

The recipe: the UNet trained through the SD denoising loss
(`diffusers.training_utils.make_sd_loss_fn`, min-SNR gamma 5.0, epsilon
target) with the DDPM scheduler's noising, AdamW at lr 1e-5 under the
TrainingArguments defaults (cosine, betas 0.9 / 0.999, eps 1e-8, clip 1.0),
max_steps 1000 as the schedule's horizon, shuffled batches of 8 over the
example's data: 256 samples of 64x64x4 latents and 77x768 hidden states
drawn from np.random.RandomState(0). The port keeps fp32 master weights and
computes in bf16 on the card, the JAX package's `cast_training_params`
under a bf16 module dtype.

Usage: python -m paddlemix_tpu_torch.tools.train_text_to_image CKPT

`main` reads the UNet (`CKPT/unet`, fp32 masters) and the scheduler config
(`CKPT/scheduler`, read as DDPM's whatever scheduler it names) of a
diffusers-layout directory, as the example does, and trains with its
`save_steps` of 500 under `output/sd`. The samples take the UNet's widths
(its `sample_size`, `in_channels` and `cross_attention_dim`: SD1.5's are the
example's 64, 4 and 768). `build_trainer` takes a UNet and a scheduler from
the caller (e.g. `diffusers.sd15.random_sd15_unet` and
`DDPMScheduler.from_config(SD15_SCHEDULER)`) and saves no checkpoint.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..datasets import DataLoader, MapDataset
from ..diffusers import DDPMScheduler, UNet2DConditionModel
from ..diffusers.training_utils import make_sd_loss_fn
from ..models.layers import set_compute_dtype
from ..trainer import Trainer, TrainingArguments


def sd_samples(n: int = 256, seed: int = 0, latent_hw: int = 64, latent_channels: int = 4,
               context_len: int = 77, context_dim: int = 768):
    """The example's data: n dicts of "latents" (latent_hw, latent_hw,
    latent_channels) and "encoder_hidden_states" (context_len, context_dim),
    float32, drawn in turn from np.random.RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return [{"latents": rng.randn(latent_hw, latent_hw, latent_channels).astype(np.float32),
             "encoder_hidden_states": rng.randn(context_len, context_dim).astype(np.float32)}
            for _ in range(n)]


def build_trainer(unet, scheduler, samples, batch_size: int = 8, **overrides) -> Trainer:
    """The example's loss, loader and TrainingArguments around `unet`: lr
    1e-5, max_steps 1000, logging every 10, no checkpoints; `overrides`
    replace TrainingArguments fields."""
    loss_fn = make_sd_loss_fn(unet, scheduler, snr_gamma=5.0)
    args = TrainingArguments(**dict(dict(output_dir="output/sd", learning_rate=1e-5,
                                         max_steps=1000, logging_steps=10, save_steps=0,
                                         benchmark=True), **overrides))
    loader = DataLoader(MapDataset(samples), batch_size=batch_size, shuffle=True)
    return Trainer(model=unet, args=args, loss_fn=loss_fn, train_dataloader=loader)


def compute_dtype(device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def training_unet(path: str, device, subfolder: str = "unet") -> UNet2DConditionModel:
    """The UNet of a pipeline directory for training: fp32 master weights
    on `device`, computing in `compute_dtype(device)`."""
    unet = UNet2DConditionModel.from_pretrained(path, subfolder=subfolder, device=device,
                                                dtype=torch.float32)
    return set_compute_dtype(unet, compute_dtype(device))


def main(argv=None, device="cuda", **overrides):
    """The example on `device` (the card by default): argv[0] is the
    checkpoint directory; `overrides` replace TrainingArguments fields (e.g.
    max_steps, output_dir). Returns (trainer, train's result)."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt = argv[0]
    unet = training_unet(ckpt, device)
    scheduler = DDPMScheduler.from_pretrained(ckpt, subfolder="scheduler")
    cfg = unet.config
    samples = sd_samples(latent_hw=cfg.sample_size, latent_channels=cfg.in_channels,
                         context_dim=cfg.cross_attention_dim)
    trainer = build_trainer(unet, scheduler, samples, **dict(dict(save_steps=500), **overrides))
    return trainer, trainer.train()


if __name__ == "__main__":
    main()
