"""Scheduler substrate: beta schedules and timestep spacing (port of
paddlemix_tpu/diffusers/schedulers/common.py, the parts the Euler and PNDM
paths use)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SchedulerConfig:
    """epsilon prediction; beta_schedule linear | scaled_linear, timestep_spacing
    leading | linspace (the JAX package has more, not ported yet)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    timestep_spacing: str = "leading"
    steps_offset: int = 0  # added to "leading" timesteps


def make_betas(cfg: SchedulerConfig) -> torch.Tensor:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return torch.linspace(cfg.beta_start, cfg.beta_end, n, dtype=torch.float32)
    if cfg.beta_schedule == "scaled_linear":
        return torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                              dtype=torch.float32) ** 2
    raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")


def make_alphas_cumprod(cfg: SchedulerConfig) -> torch.Tensor:
    return torch.cumprod(1.0 - make_betas(cfg), dim=0)


def spaced_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending int timesteps per the reference spacing conventions."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        ts += cfg.steps_offset
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing!r}")
    return ts


class Scheduler:
    """Base: config + alphas_cumprod. Subclasses define set_timesteps/step
    over an explicit state object, as the JAX package does."""

    config_class = SchedulerConfig

    def __init__(self, **config):
        self.config = self.config_class(**config)
        self.alphas_cumprod = make_alphas_cumprod(self.config)

    def scale_model_input(self, state, sample, i):
        return sample

    @property
    def init_noise_sigma(self) -> float:
        return 1.0
