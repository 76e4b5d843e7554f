"""FlowMatch Euler scheduler for SD3 (port of
paddlemix_tpu/diffusers/schedulers/scheduling_flow_match.py, with its static
shift; dynamic shifting is not ported and a config that sets it raises).

Its config is the JAX package's: `SchedulerConfig`'s fields (unused here)
and `shift`, read from and written to `scheduler_config.json` by
`from_pretrained` / `save_pretrained` (common.py's `Scheduler`), diffusers'
published one (`num_train_timesteps`, `shift`) included.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import Scheduler, SchedulerConfig


@dataclasses.dataclass
class FlowMatchConfig(SchedulerConfig):
    model_type = "flow_match_euler"
    shift: float = 3.0
    use_dynamic_shifting: bool = False

    def __post_init__(self):
        if self.use_dynamic_shifting:
            raise NotImplementedError("FlowMatchConfig: use_dynamic_shifting is not ported")


class FlowMatchState(NamedTuple):
    timesteps: torch.Tensor  # (N,) fp32 on the host: sigma * num_train_timesteps
    sigmas: torch.Tensor     # (N+1,) fp32 on the host, last is 0
    num_inference_steps: int


class FlowMatchEulerDiscreteScheduler(Scheduler):
    config_class = FlowMatchConfig

    def __init__(self, config: Optional[FlowMatchConfig] = None, **kwargs):
        if config is None:
            config = self.config_class.from_dict(kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = config
        self.alphas_cumprod = None  # flow matching has no VP alphas

    def set_timesteps(self, num_inference_steps: int) -> FlowMatchState:
        """Shifted sigmas computed in float64 numpy, then kept as fp32."""
        n = self.config.num_train_timesteps
        shift = self.config.shift
        sigmas = np.linspace(1.0, 1.0 / n, num_inference_steps)
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        timesteps = torch.tensor(sigmas * n, dtype=torch.float32)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return FlowMatchState(timesteps, torch.from_numpy(sigmas), num_inference_steps)

    def step(self, state: FlowMatchState, model_output, i, sample):
        """One Euler step of the flow ODE in fp32; returns (prev_sample in
        sample's dtype, state)."""
        sigma, sigma_next = state.sigmas[i], state.sigmas[i + 1]
        prev = sample.float() + (sigma_next - sigma) * model_output.float()
        return prev.to(sample.dtype), state
