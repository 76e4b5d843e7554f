"""SD UNet fine-tuning (port of examples/train_text_to_image.py).

The recipe: the UNet trained through the SD denoising loss
(`diffusers.training_utils.make_sd_loss_fn`, min-SNR gamma 5.0, epsilon
target) with the DDPM scheduler's noising, AdamW at lr 1e-5 under the
TrainingArguments defaults (cosine, betas 0.9 / 0.999, eps 1e-8, clip 1.0),
max_steps 1000 as the schedule's horizon, shuffled batches of 8 over the
example's data: 256 samples of 64x64x4 latents and 77x768 hidden states
drawn from np.random.RandomState(0). The port keeps fp32 master weights and
computes in bf16 (`diffusers.sd15.random_sd15_unet`), the JAX package's
`cast_training_params` under a bf16 module dtype.

The example reads the UNet and the scheduler from a checkpoint
(`sys.argv[1]`); none is in the repository, so `main` raises there, and
`build_trainer` takes a UNet and a scheduler from the caller (e.g.
`random_sd15_unet` and `DDPMScheduler.from_config(SD15_SCHEDULER)`, the
checkpoint's scheduler config read as DDPM's). Checkpoints are not ported,
so `save_steps` is 0.
"""

from __future__ import annotations

import sys

import numpy as np

from ..datasets import DataLoader, MapDataset
from ..diffusers.training_utils import make_sd_loss_fn
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    raise NotImplementedError(
        f"train_text_to_image {' '.join(argv)}: reading a UNet and scheduler checkpoint is not "
        f"ported yet; build one with diffusers.sd15.random_sd15_unet and "
        f"DDPMScheduler.from_config, then call build_trainer(unet, scheduler, sd_samples())")


if __name__ == "__main__":
    main()
