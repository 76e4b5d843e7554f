"""Class-conditional DiT training (port of examples/train_dit.py).

The recipe: epsilon-prediction DDPM loss on the first `in_channels` output
channels (learned sigma's mean half), timesteps drawn uniformly from [0,
num_train_timesteps) and the noise normal, the DDPM scheduler's noising at
its defaults (linear betas over 1,000 steps); AdamW at lr 1e-4 under the
TrainingArguments defaults, max_steps 400,000, logging every 50, checkpoints
every 10,000 under `output/dit`, shuffled batches of 16 over the example's
512 samples of (sample_size, sample_size, in_channels) latents and labels
drawn from np.random.RandomState(0). The port keeps fp32 master weights and
computes in bf16 on the card (fp32 on the CPU).

As in JAX, no label is ever dropped: the example passes the model no rng
(`rng=... if False else None`), so CFG's null class is never trained
(ROADMAP C.35, kept).

Usage: python -m paddlemix_tpu_torch.tools.train_dit [CONFIG_DIR]

`main` builds the DiT of `DiTConfig`'s defaults (DiT-XL/2-256), or of the
config.json in CONFIG_DIR, with seeded weights at JAX's init
(adaLN-zero: `diffusers.dit.random_dit(adaln_zero=True)`), as the example's
`DiTModel.from_config` does. `build_trainer` takes a model and a scheduler
from the caller and saves no checkpoint.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..datasets import DataLoader, MapDataset
from ..diffusers import DDPMScheduler, DiTConfig
from ..diffusers.dit import random_dit
from ..trainer import Trainer, TrainingArguments
from .train_text_to_image import compute_dtype


def dit_samples(n: int = 512, seed: int = 0, sample_size: int = 32, in_channels: int = 4,
                num_classes: int = 1000):
    """The example's data: n dicts of "latents" (sample_size, sample_size,
    in_channels) float32 and "labels" int32, drawn in turn from
    np.random.RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return [{"latents": rng.randn(sample_size, sample_size, in_channels).astype(np.float32),
             "labels": np.int32(rng.randint(num_classes))} for _ in range(n)]


def dit_loss(model, scheduler, batch, timesteps, noise):
    """The loss at given `timesteps` (B,) int and `noise` (the latents'
    shape, fp32): the latents noised by `scheduler.add_noise`, the model (in
    its compute dtype) predicting the noise in its first channels, the mean
    squared error over every element. batch: {"latents": (B, s, s, C),
    "labels": (B,) int}."""
    latents = batch["latents"].float()
    noisy = scheduler.add_noise(latents, noise, timesteps)
    pred = model(noisy.to(model.dtype), timesteps, batch["labels"].long())
    return ((pred[..., :latents.shape[-1]].float() - noise) ** 2).mean()


def make_dit_loss_fn(model, scheduler):
    """loss_fn(params, batch, rng) for DiT training: timesteps and noise
    drawn from `rng` (a torch.Generator on the batch's device), then
    `dit_loss`. The params live in `model`; `params` holds them by
    reference."""
    num_train = len(scheduler.alphas_cumprod)

    def loss_fn(params, batch, rng):
        latents = batch["latents"]
        t = torch.randint(0, num_train, (latents.shape[0],), generator=rng,
                          device=latents.device)
        noise = torch.randn(latents.shape, generator=rng, device=latents.device,
                            dtype=torch.float32)
        return dit_loss(model, scheduler, batch, t, noise)

    return loss_fn


def build_trainer(model, scheduler, samples, batch_size: int = 16, **overrides) -> Trainer:
    """The example's loss, loader and TrainingArguments around `model`: lr
    1e-4, max_steps 400,000, logging every 50, no checkpoints; `overrides`
    replace TrainingArguments fields."""
    args = TrainingArguments(**dict(dict(output_dir="output/dit", learning_rate=1e-4,
                                         max_steps=400_000, logging_steps=50, save_steps=0,
                                         benchmark=True), **overrides))
    loader = DataLoader(MapDataset(samples), batch_size=batch_size, shuffle=True)
    return Trainer(model=model, args=args, loss_fn=make_dit_loss_fn(model, scheduler),
                   train_dataloader=loader)


def main(argv=None, device="cuda", **overrides):
    """The example on `device` (the card by default): argv[0], if given, is a
    directory whose config.json is the DiT's; `overrides` replace
    TrainingArguments fields (e.g. max_steps, output_dir). Returns (trainer,
    train's result)."""
    argv = sys.argv[1:] if argv is None else argv
    cfg = DiTConfig.from_pretrained(argv[0]) if argv else DiTConfig()
    fields = {k: v for k, v in cfg.to_dict().items() if k not in ("model_type", "_class_name")}
    model = random_dit(device, torch.float32, config=fields,
                       compute_dtype=compute_dtype(device), adaln_zero=True)
    samples = dit_samples(sample_size=cfg.sample_size, in_channels=cfg.in_channels,
                          num_classes=cfg.num_classes)
    trainer = build_trainer(model, DDPMScheduler(num_train_timesteps=1000), samples,
                            **dict(dict(save_steps=10_000), **overrides))
    return trainer, trainer.train()


if __name__ == "__main__":
    main()
