"""DDIM scheduler (port of paddlemix_tpu/diffusers/schedulers/scheduling_ddim.py):
the deterministic sampler at `eta` 0, and at `eta` > 0 with noise drawn from
an explicit torch.Generator or given, as the JAX step takes a key (with
neither, the step adds none: JAX's key=None, which its pipelines pass)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .common import Scheduler, SchedulerConfig, predicted_eps, predicted_x0, spaced_timesteps


@dataclasses.dataclass
class DDIMConfig(SchedulerConfig):
    model_type = "ddim"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    thresholding: bool = False  # a field of JAX's config that its step never reads
    eta: float = 0.0

    def __post_init__(self):
        if self.thresholding:
            raise NotImplementedError("DDIMScheduler: thresholding is not ported (the JAX "
                                      "package's step never reads it)")


class DDIMState(NamedTuple):
    timesteps: torch.Tensor       # (N,) int64 on the host, descending
    prev_timesteps: torch.Tensor  # (N,) int64: timesteps - num_train // N (the last < 0)
    num_inference_steps: int


class DDIMScheduler(Scheduler):
    config_class = DDIMConfig

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        ts = spaced_timesteps(self.config, num_inference_steps)
        step = self.config.num_train_timesteps // num_inference_steps
        return DDIMState(torch.from_numpy(ts.copy()), torch.from_numpy(ts - step),
                         num_inference_steps)

    def step(self, state: DDIMState, model_output, i, sample,
             generator: Optional[torch.Generator] = None, noise=None):
        """One DDIM step in fp32; returns (prev_sample in sample's dtype,
        state). At `eta` > 0 sigma times `noise` is added when given, else
        times a normal draw from `generator` (on sample's device)."""
        cfg = self.config
        t, prev_t = int(state.timesteps[i]), int(state.prev_timesteps[i])
        acp = self.alphas_cumprod
        alpha_prod_t = acp[t]
        final_alpha = torch.tensor(1.0) if cfg.set_alpha_to_one else acp[0]
        alpha_prod_prev = acp[prev_t] if prev_t >= 0 else final_alpha

        sample32, out32 = sample.float(), model_output.float()
        x0 = predicted_x0(out32, sample32, alpha_prod_t, cfg.prediction_type)
        eps = predicted_eps(out32, sample32, alpha_prod_t, cfg.prediction_type)
        if cfg.clip_sample:
            x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

        beta_prod_prev = 1.0 - alpha_prod_prev
        variance = (beta_prod_prev / (1.0 - alpha_prod_t)) * (1.0 - alpha_prod_t / alpha_prod_prev)
        sigma = cfg.eta * torch.sqrt(variance.clamp_min(0.0))
        dir_xt = torch.sqrt((beta_prod_prev - sigma ** 2).clamp_min(0.0)) * eps
        prev = torch.sqrt(alpha_prod_prev) * x0 + dir_xt
        if cfg.eta > 0.0:
            if noise is None and generator is not None:
                noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                    dtype=torch.float32).to(sample.dtype)
            if noise is not None:
                prev = prev + sigma * noise.float()
        return prev.to(sample.dtype), state
