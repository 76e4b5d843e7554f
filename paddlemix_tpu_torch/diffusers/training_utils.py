"""Diffusion training utilities (port of
paddlemix_tpu/diffusers/training_utils.py): min-SNR-gamma weights, the SD
denoising loss and `cast_training_params`.

The loss is split in two. `sd_loss` is the plain function of given
timesteps and noise; `make_sd_loss_fn` builds the Trainer's
`loss_fn(params, batch, rng)`, which draws the timesteps uniformly from
[0, num_train_timesteps) and the noise normal from `rng`, a torch.Generator
on the batch's device (the Trainer's, seeded from its args), and calls it.
torch and jax.random give different numbers from one seed, so the tests
replay JAX's draws through `sd_loss`. SD3's flow-match loss is split the same
way: `flow_match_loss` at given draws, `make_flow_match_loss_fn` drawing them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def compute_snr(alphas_cumprod, timesteps):
    """SNR(t) = alpha^2 / sigma^2 (reference training_utils.py:45)."""
    a = alphas_cumprod.to(timesteps.device)[timesteps]
    return a / (1.0 - a)


def snr_weights(alphas_cumprod, timesteps, snr_gamma: float = 5.0,
                prediction_type: str = "epsilon"):
    """Min-SNR-gamma loss weights (reference SDXL trainer --snr_gamma)."""
    snr = compute_snr(alphas_cumprod, timesteps)
    w = torch.clamp(snr, max=snr_gamma)
    if prediction_type == "epsilon":
        w = w / torch.clamp(snr, min=1e-8)
    elif prediction_type == "v_prediction":
        w = w / (snr + 1.0)
    return w


def sd_loss(unet, scheduler, batch, timesteps, noise, *, prediction_type: str = "epsilon",
            snr_gamma: Optional[float] = None, added_cond_kwargs=None):
    """The denoising loss at given `timesteps` (B,) int and `noise` (the
    latents' shape, fp32): latents noised by `scheduler.add_noise`, the UNet
    (NHWC, in its compute dtype) predicting the epsilon, v or sample target,
    the mean squared error per example, weighted by min-SNR-gamma when
    `snr_gamma` is set, then averaged. batch: {"latents": (B, h, w, 4) VAE
    latents (pre-scaled), "encoder_hidden_states": (B, S, D)}."""
    latents = batch["latents"].float()
    noisy = scheduler.add_noise(latents, noise, timesteps)
    pred = unet(noisy.to(unet.dtype), timesteps,
                batch["encoder_hidden_states"].to(unet.dtype),
                added_cond_kwargs=added_cond_kwargs).float()
    if prediction_type == "epsilon":
        target = noise
    elif prediction_type == "v_prediction":
        target = scheduler.get_velocity(latents, noise, timesteps)
    else:
        target = latents
    per_ex = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    if snr_gamma is not None:
        per_ex = per_ex * snr_weights(scheduler.alphas_cumprod, timesteps, snr_gamma,
                                      prediction_type)
    return per_ex.mean()


def make_sd_loss_fn(unet, scheduler, *, prediction_type: str = "epsilon",
                    snr_gamma: Optional[float] = None,
                    added_cond_fn: Optional[Callable] = None):
    """loss_fn(params, batch, rng) for UNet training: timesteps and noise
    drawn from `rng` (a torch.Generator on the batch's device), then
    `sd_loss`. `added_cond_fn(batch)` gives SDXL's added_cond_kwargs. The
    params live in `unet`; `params` holds them by reference."""
    num_train = scheduler.config.num_train_timesteps

    def loss_fn(params, batch, rng):
        latents = batch["latents"]
        t = torch.randint(0, num_train, (latents.shape[0],), generator=rng,
                          device=latents.device)
        noise = torch.randn(latents.shape, generator=rng, device=latents.device,
                            dtype=torch.float32)
        added = added_cond_fn(batch) if added_cond_fn is not None else None
        return sd_loss(unet, scheduler, batch, t, noise, prediction_type=prediction_type,
                       snr_gamma=snr_gamma, added_cond_kwargs=added)

    return loss_fn


def flow_match_loss(transformer, batch, u, noise, shift: float = 3.0,
                    num_train_timesteps: int = 1000):
    """SD3's flow-matching loss at given draws: `u` (B,) uniform in [0, 1)
    and `noise` (the latents' shape, fp32). sigma = shift u / (1 + (shift -
    1) u), t = num_train_timesteps sigma, x_t = (1 - sigma) x0 + sigma noise;
    the transformer (NHWC, in its compute dtype) predicts the velocity
    target noise - x0, and the loss is the mean squared error over every
    element (JAX's `make_flow_match_loss_fn`). batch: {"latents": (B, h, w,
    C) pre-scaled VAE latents, "encoder_hidden_states": (B, L, joint dim),
    "pooled_projections": (B, pooled dim)}."""
    latents = batch["latents"].float()
    sigma = shift * u / (1.0 + (shift - 1.0) * u)
    t = sigma * num_train_timesteps
    s = sigma[:, None, None, None]
    noisy = (1.0 - s) * latents + s * noise
    dtype = transformer.dtype
    pred = transformer(noisy.to(dtype), t, batch["encoder_hidden_states"].to(dtype),
                       batch["pooled_projections"].to(dtype)).float()
    return ((pred - (noise - latents)) ** 2).mean()


def make_flow_match_loss_fn(transformer, scheduler, *, shift: float = 3.0):
    """loss_fn(params, batch, rng) for SD3 training: u (B,) uniform, then the
    noise normal, drawn in that order from `rng` (a torch.Generator on the
    batch's device), then `flow_match_loss` at the scheduler's
    num_train_timesteps. The params live in `transformer`; `params` holds
    them by reference."""
    num_train = scheduler.config.num_train_timesteps

    def loss_fn(params, batch, rng):
        latents = batch["latents"]
        u = torch.rand((latents.shape[0],), generator=rng, device=latents.device)
        noise = torch.randn(latents.shape, generator=rng, device=latents.device,
                            dtype=torch.float32)
        return flow_match_loss(transformer, batch, u, noise, shift=shift,
                               num_train_timesteps=num_train)

    return loss_fn


def cast_training_params(model: nn.Module, dtype=torch.float32) -> nn.Module:
    """Keep the trainable floating parameters in `dtype` (fp32 masters) while
    the model computes in its compute dtype (reference
    cast_training_params), in place. Returns `model`."""
    for p in model.parameters():
        if p.requires_grad and p.is_floating_point():
            p.data = p.data.to(dtype)
    return model
