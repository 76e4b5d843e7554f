"""Euler discrete scheduler (port of
paddlemix_tpu/diffusers/schedulers/scheduling_euler.py, without Karras sigmas)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .common import Scheduler, SchedulerConfig, spaced_timesteps


@dataclasses.dataclass
class EulerConfig(SchedulerConfig):
    model_type = "euler"
    use_karras_sigmas: bool = False  # True is not ported
    interpolation_type: str = "linear"
    timestep_spacing: str = "linspace"


class EulerState(NamedTuple):
    timesteps: torch.Tensor  # (N,) fp32 on the host, training-timestep units
    sigmas: torch.Tensor     # (N+1,) fp32 on the host, last is 0
    num_inference_steps: int


class EulerDiscreteScheduler(Scheduler):
    config_class = EulerConfig

    def __init__(self, config=None, **kwargs):
        super().__init__(config, **kwargs)
        cfg = self.config
        if cfg.use_karras_sigmas or cfg.interpolation_type != "linear" or \
                cfg.prediction_type != "epsilon":
            raise NotImplementedError(
                f"EulerDiscreteScheduler: use_karras_sigmas {cfg.use_karras_sigmas}, "
                f"interpolation_type {cfg.interpolation_type!r}, prediction_type "
                f"{cfg.prediction_type!r}: only linear sigmas and epsilon are ported")

    def _full_sigmas(self) -> np.ndarray:
        acp = self.alphas_cumprod.numpy()
        return ((1.0 - acp) / acp) ** 0.5

    @property
    def init_noise_sigma(self) -> float:
        s = self._full_sigmas()
        if self.config.timestep_spacing == "linspace":
            return float(s.max())
        return float((s.max() ** 2 + 1) ** 0.5)

    def set_timesteps(self, num_inference_steps: int) -> EulerState:
        full = self._full_sigmas()
        ts = spaced_timesteps(self.config, num_inference_steps).astype(np.float64)
        sigmas = np.interp(ts, np.arange(len(full)), full)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return EulerState(torch.tensor(ts, dtype=torch.float32), torch.from_numpy(sigmas),
                          num_inference_steps)

    def scale_model_input(self, state: EulerState, sample, i):
        sigma = state.sigmas[i]
        return sample / torch.sqrt(sigma ** 2 + 1.0).to(sample.dtype)

    def step(self, state: EulerState, model_output, i, sample):
        """One Euler step in fp32 (epsilon prediction); returns (prev_sample in
        sample's dtype, state)."""
        sigma, sigma_next = state.sigmas[i], state.sigmas[i + 1]
        sample32 = sample.float()
        x0 = sample32 - sigma * model_output.float()
        derivative = (sample32 - x0) / sigma
        prev = sample32 + (sigma_next - sigma) * derivative
        return prev.to(sample.dtype), state
