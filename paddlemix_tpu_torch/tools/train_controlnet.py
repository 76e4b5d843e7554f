"""ControlNet training (port of examples/train_controlnet.py).

The recipe: the SD UNet frozen, the ControlNet alone trained through the
epsilon MSE (fp32) of the UNet's prediction under the ControlNet's
residuals, the latents noised by the DDPM scheduler at timesteps drawn
uniformly; the Trainer's defaults otherwise (AdamW, cosine, clip 1.0) at lr
1e-5, max_steps 50,000 as the schedule's horizon, logging every 20,
checkpoints every 5,000 under `output/controlnet`, shuffled batches of 4
over the example's data: 256 samples of 64x64x4 latents, 77x768 hidden
states and a 512x512x3 conditioning image in [0, 1), drawn in turn from
np.random.RandomState(0).

Usage: python -m paddlemix_tpu_torch.tools.train_controlnet CKPT

`main` reads the UNet (`CKPT/unet`), the ControlNet (`CKPT/controlnet`; JAX
has no `from_unet`, so neither has the port) and the scheduler config
(`CKPT/scheduler`, read as DDPM's) of a pipeline directory. Both models keep
fp32 parameters and compute in bf16 on the card (fp32 on the CPU); the
UNet's parameters take no gradient, its activations do: the ControlNet's
gradient flows back through the UNet's mid and up blocks. The Trainer's
weight-decay mask is JAX's, on the ControlNet's flax names. The samples
take the models' widths (the UNet's `sample_size`, `in_channels` and
`cross_attention_dim`, the ControlNet's conditioning factor and channels).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..datasets import DataLoader, MapDataset
from ..diffusers import ControlNetModel, DDPMScheduler
from ..models.layers import set_compute_dtype
from ..trainer import Trainer, TrainingArguments
from .train_text_to_image import compute_dtype, training_unet


def controlnet_samples(n: int = 256, seed: int = 0, latent_hw: int = 64,
                       latent_channels: int = 4, context_len: int = 77, context_dim: int = 768,
                       cond_hw: int = 512, cond_channels: int = 3):
    """The example's data: n dicts of "latents" (normal), "encoder_hidden_states"
    (normal) and "conditioning" (uniform in [0, 1)), float32, drawn in turn from
    np.random.RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return [{"latents": rng.randn(latent_hw, latent_hw, latent_channels).astype(np.float32),
             "encoder_hidden_states": rng.randn(context_len, context_dim).astype(np.float32),
             "conditioning": rng.rand(cond_hw, cond_hw, cond_channels).astype(np.float32)}
            for _ in range(n)]


def controlnet_loss(unet, controlnet, scheduler, batch, timesteps, noise):
    """The example's loss at given `timesteps` (B,) and `noise` (fp32, the
    latents' shape): the latents noised by `scheduler.add_noise`, the
    ControlNet's residuals of the noisy latents, the context and the
    conditioning image, the UNet's epsilon prediction under them, and the
    mean squared error in fp32. Each model computes in its own dtype."""
    latents = batch["latents"].float()
    noisy = scheduler.add_noise(latents, noise, timesteps)
    ctx = batch["encoder_hidden_states"]
    down, mid = controlnet(noisy.to(controlnet.dtype), timesteps, ctx.to(controlnet.dtype),
                           batch["conditioning"].to(controlnet.dtype))
    pred = unet(noisy.to(unet.dtype), timesteps, ctx.to(unet.dtype),
                down_block_additional_residuals=down, mid_block_additional_residual=mid)
    return ((pred.float() - noise) ** 2).mean()


def make_controlnet_loss_fn(unet, controlnet, scheduler):
    """loss_fn(params, batch, rng) for the Trainer: the timesteps uniform in
    [0, num_train_timesteps), then the noise normal, drawn from `rng` (a
    torch.Generator on the batch's device), then `controlnet_loss`. The UNet
    is frozen here (its parameters take no gradient); `params` are the
    ControlNet's, held by reference."""
    unet.requires_grad_(False)
    num_train = scheduler.config.num_train_timesteps

    def loss_fn(params, batch, rng):
        latents = batch["latents"]
        t = torch.randint(0, num_train, (latents.shape[0],), generator=rng, device=latents.device)
        noise = torch.randn(latents.shape, generator=rng, device=latents.device,
                            dtype=torch.float32)
        return controlnet_loss(unet, controlnet, scheduler, batch, t, noise)

    return loss_fn


def build_trainer(unet, controlnet, scheduler, samples, batch_size: int = 4,
                  **overrides) -> Trainer:
    """The example's loss, loader and TrainingArguments around `controlnet`
    (the Trainer's parameters: the ControlNet's alone); `overrides` replace
    TrainingArguments fields."""
    args = TrainingArguments(**dict(dict(output_dir="output/controlnet", learning_rate=1e-5,
                                         max_steps=50_000, logging_steps=20, save_steps=5_000),
                                    **overrides))
    loader = DataLoader(MapDataset(samples), batch_size=batch_size, shuffle=True)
    return Trainer(model=controlnet, args=args,
                   loss_fn=make_controlnet_loss_fn(unet, controlnet, scheduler),
                   train_dataloader=loader)


def main(argv=None, device="cuda", **overrides):
    """The example on `device` (the card by default): argv[0] is the
    pipeline directory; `overrides` replace TrainingArguments fields (e.g.
    max_steps, output_dir). Returns (trainer, train's result)."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt = argv[0]
    unet = training_unet(ckpt, device)
    controlnet = ControlNetModel.from_pretrained(ckpt, subfolder="controlnet", device=device,
                                                 dtype=torch.float32)
    set_compute_dtype(controlnet, compute_dtype(device))
    scheduler = DDPMScheduler.from_pretrained(ckpt, subfolder="scheduler")
    cfg = unet.config
    samples = controlnet_samples(latent_hw=cfg.sample_size, latent_channels=cfg.in_channels,
                                 context_dim=cfg.cross_attention_dim,
                                 cond_hw=cfg.sample_size * controlnet.cond_scale_factor,
                                 cond_channels=controlnet.config.conditioning_channels)
    trainer = build_trainer(unet, controlnet, scheduler, samples, **overrides)
    return trainer, trainer.train()


if __name__ == "__main__":
    main()
