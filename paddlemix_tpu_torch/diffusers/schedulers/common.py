"""Scheduler substrate: beta schedules, timestep spacing, prediction types
and the forward diffusion of training (port of
paddlemix_tpu/diffusers/schedulers/common.py, the parts the Euler, PNDM and
DDPM paths use)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SchedulerConfig:
    """beta_schedule linear | scaled_linear, timestep_spacing leading |
    linspace (the JAX package has more, not ported yet). `prediction_type`
    (epsilon | v_prediction | sample) is read by DDPM's step; Euler and PNDM
    step epsilon."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
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


def predicted_x0(model_output, sample, alpha_prod_t, prediction_type: str):
    """Convert a model output into the x0 estimate (shared by all solvers)."""
    beta_prod_t = 1.0 - alpha_prod_t
    if prediction_type == "epsilon":
        return (sample - beta_prod_t ** 0.5 * model_output) / alpha_prod_t ** 0.5
    if prediction_type == "v_prediction":
        return alpha_prod_t ** 0.5 * sample - beta_prod_t ** 0.5 * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def _at(alphas_cumprod, timesteps, like):
    """alphas_cumprod[timesteps] in like's dtype, on its device, shaped to
    broadcast over like's trailing dims."""
    a = alphas_cumprod.to(like.device)[timesteps].to(like.dtype)
    return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))


def add_noise_common(alphas_cumprod, original_samples, noise, timesteps):
    """Forward diffusion q(x_t | x_0) (training: reference add_noise)."""
    a = _at(alphas_cumprod, timesteps, original_samples)
    return a ** 0.5 * original_samples + (1.0 - a) ** 0.5 * noise


def velocity_common(alphas_cumprod, sample, noise, timesteps):
    """v-prediction target (reference get_velocity)."""
    a = _at(alphas_cumprod, timesteps, sample)
    return a ** 0.5 * noise - (1.0 - a) ** 0.5 * sample


class Scheduler:
    """Base: config + alphas_cumprod. Subclasses define set_timesteps/step
    over an explicit state object, as the JAX package does."""

    config_class = SchedulerConfig

    def __init__(self, **config):
        self.config = self.config_class(**config)
        self.alphas_cumprod = make_alphas_cumprod(self.config)

    @classmethod
    def from_config(cls, config_dict: dict, **overrides):
        """From a scheduler config of any kind (e.g. a checkpoint's, which
        names its own scheduler): the fields of this one's config are kept and
        the others dropped, as the JAX package's `from_config` keeps them
        aside."""
        names = {f.name for f in dataclasses.fields(cls.config_class)}
        return cls(**{k: v for k, v in dict(config_dict, **overrides).items() if k in names})

    def add_noise(self, original_samples, noise, timesteps):
        return add_noise_common(self.alphas_cumprod, original_samples, noise, timesteps)

    def get_velocity(self, sample, noise, timesteps):
        return velocity_common(self.alphas_cumprod, sample, noise, timesteps)

    def scale_model_input(self, state, sample, i):
        return sample

    @property
    def init_noise_sigma(self) -> float:
        return 1.0
