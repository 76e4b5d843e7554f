"""DDPM ancestral sampler (port of
paddlemix_tpu/diffusers/schedulers/scheduling_ddpm.py): the scheduler that
SD training noises with (`Scheduler.add_noise`), and a sampler whose step
draws its noise from an explicit torch.Generator, as the JAX step takes a
key."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .common import Scheduler, SchedulerConfig, predicted_x0, spaced_timesteps


@dataclasses.dataclass
class DDPMConfig(SchedulerConfig):
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    variance_type: str = "fixed_small"  # fixed_small | fixed_large


class DDPMState(NamedTuple):
    timesteps: torch.Tensor       # (N,) int64 on the host, descending
    prev_timesteps: torch.Tensor  # (N,) int64: timesteps - num_train // N (the last < 0)
    num_inference_steps: int


class DDPMScheduler(Scheduler):
    config_class = DDPMConfig

    def set_timesteps(self, num_inference_steps: int) -> DDPMState:
        ts = spaced_timesteps(self.config, num_inference_steps)
        step = self.config.num_train_timesteps // num_inference_steps
        return DDPMState(torch.from_numpy(ts.copy()), torch.from_numpy(ts - step),
                         num_inference_steps)

    def step(self, state: DDPMState, model_output, i, sample,
             generator: Optional[torch.Generator] = None, noise=None):
        """One ancestral step in fp32; returns (prev_sample in sample's dtype,
        state). The variance noise is `noise` when given, else drawn normal
        from `generator` (on sample's device); with neither, the step adds
        none (JAX's key=None)."""
        cfg = self.config
        t, prev_t = int(state.timesteps[i]), int(state.prev_timesteps[i])
        acp = self.alphas_cumprod
        alpha_prod_t = acp[t]
        alpha_prod_prev = acp[prev_t] if prev_t >= 0 else torch.tensor(1.0)
        beta_prod_t = 1.0 - alpha_prod_t
        current_alpha = alpha_prod_t / alpha_prod_prev
        current_beta = 1.0 - current_alpha

        sample32 = sample.float()
        x0 = predicted_x0(model_output.float(), sample32, alpha_prod_t, cfg.prediction_type)
        if cfg.clip_sample:
            x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

        x0_coeff = alpha_prod_prev.sqrt() * current_beta / beta_prod_t
        xt_coeff = current_alpha.sqrt() * (1.0 - alpha_prod_prev) / beta_prod_t
        prev = x0_coeff * x0 + xt_coeff * sample32

        if cfg.variance_type == "fixed_large":
            variance = current_beta
        else:
            variance = (1.0 - alpha_prod_prev) / beta_prod_t * current_beta
        variance = variance.clamp_min(1e-20)
        if noise is None and generator is not None:
            noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                dtype=torch.float32).to(sample.dtype)
        if noise is not None and prev_t >= 0:
            prev = prev + variance.sqrt() * noise.float()
        return prev.to(sample.dtype), state
