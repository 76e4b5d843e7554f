"""Scheduler substrate: beta schedules, timestep spacing, prediction types,
the forward diffusion of training and the `scheduler_config.json` IO (port
of paddlemix_tpu/diffusers/schedulers/common.py, the parts the Euler, PNDM,
DDPM, DDIM, UniPC and DPM-Solver++ paths use).

A scheduler's config is a `BaseConfig`: `from_pretrained(path, subfolder)`
reads `scheduler_config.json` as the JAX package does, keeping the keys its
config has no field for in `unused_kwargs` (a checkpoint's config names its
own scheduler: SD1.5's PNDM config read as DDPM's for training), and
`save_pretrained` writes the JAX package's file.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.config import BaseConfig


@dataclasses.dataclass
class SchedulerConfig(BaseConfig):
    """beta_schedule linear | scaled_linear, or `trained_betas`;
    timestep_spacing leading | linspace | trailing. `prediction_type`
    (epsilon | v_prediction | sample) is read by DDPM's, DDIM's, UniPC's and
    DPM-Solver++'s steps; Euler and PNDM step epsilon and refuse the others."""

    config_name = "scheduler_config.json"
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"
    steps_offset: int = 0  # added to "leading" timesteps
    trained_betas: Optional[Tuple[float, ...]] = None


def make_betas(cfg: SchedulerConfig) -> torch.Tensor:
    if cfg.trained_betas is not None:
        return torch.tensor(cfg.trained_betas, dtype=torch.float32)
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
    elif cfg.timestep_spacing == "trailing":
        ratio = n / num_inference_steps
        ts = np.round(np.arange(n, 0, -ratio)).astype(np.int64) - 1
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


def predicted_eps(model_output, sample, alpha_prod_t, prediction_type: str):
    """Convert a model output into the epsilon estimate."""
    beta_prod_t = 1.0 - alpha_prod_t
    if prediction_type == "epsilon":
        return model_output
    if prediction_type == "v_prediction":
        return alpha_prod_t ** 0.5 * model_output + beta_prod_t ** 0.5 * sample
    if prediction_type == "sample":
        return (sample - alpha_prod_t ** 0.5 * model_output) / beta_prod_t ** 0.5
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
    over an explicit state object, as the JAX package does. `config` is a
    config object, or its fields as keywords (keys it has no field for are
    kept aside in its `unused_kwargs`, as the JAX package keeps them)."""

    config_class = SchedulerConfig

    def __init__(self, config: Optional[SchedulerConfig] = None, **kwargs):
        if config is None:
            config = self.config_class.from_dict(kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = config
        self.alphas_cumprod = make_alphas_cumprod(self.config)

    @classmethod
    def from_config(cls, config_dict: dict, **overrides):
        """From a scheduler config of any kind (e.g. a checkpoint's, which
        names its own scheduler): the fields of this one's config are kept and
        the others set aside, as the JAX package's `from_config` does."""
        return cls(cls.config_class.from_dict(dict(config_dict), **overrides))

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, **overrides):
        """From `scheduler_config.json` in directory `path` (or its `subfolder`)."""
        return cls(cls.config_class.from_pretrained(path, subfolder=subfolder, **overrides))

    def save_pretrained(self, path: str) -> None:
        self.config.save_pretrained(path)

    def add_noise(self, original_samples, noise, timesteps):
        return add_noise_common(self.alphas_cumprod, original_samples, noise, timesteps)

    def get_velocity(self, sample, noise, timesteps):
        return velocity_common(self.alphas_cumprod, sample, noise, timesteps)

    def scale_model_input(self, state, sample, i):
        return sample

    @property
    def init_noise_sigma(self) -> float:
        return 1.0
