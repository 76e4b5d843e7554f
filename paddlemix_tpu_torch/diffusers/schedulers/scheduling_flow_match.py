"""FlowMatch Euler scheduler for SD3 (port of
paddlemix_tpu/diffusers/schedulers/scheduling_flow_match.py, with its static
shift; dynamic shifting is not ported)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class FlowMatchConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0


class FlowMatchState(NamedTuple):
    timesteps: torch.Tensor  # (N,) fp32 on the host: sigma * num_train_timesteps
    sigmas: torch.Tensor     # (N+1,) fp32 on the host, last is 0
    num_inference_steps: int


class FlowMatchEulerDiscreteScheduler:
    def __init__(self, **config):
        self.config = FlowMatchConfig(**config)

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
