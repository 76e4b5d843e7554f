"""UniPC multistep scheduler (port of
paddlemix_tpu/diffusers/schedulers/scheduling_unipc.py): the JAX package's
order-2 multistep predictor in data-prediction form, with no UniC corrector
(ROADMAP C.31; the port matches it).

Each step converts the model output to x0, takes the first-order
(DPM-Solver++ 1) step from lambda_i to lambda_{i+1}, and from the second
step on corrects it with the difference to the previous x0 over the ratio of
the lambda steps, with the expm1(-h) / 2 coefficient. The first step, and
the last with `lower_order_final`, stay first order. The alpha / sigma /
lambda tables are built as JAX builds them, in numpy from the fp32
alphas_cumprod, with alpha 1 and sigma 1e-9 past the last timestep.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .common import Scheduler, SchedulerConfig, spaced_timesteps


@dataclasses.dataclass
class UniPCConfig(SchedulerConfig):
    model_type = "unipc"
    solver_order: int = 2
    timestep_spacing: str = "linspace"
    lower_order_final: bool = True


class UniPCState(NamedTuple):
    timesteps: torch.Tensor  # (N,) int64 on the host, descending
    alpha_t: torch.Tensor    # (N + 1,) fp32 on the host
    sigma_t: torch.Tensor    # (N + 1,) fp32
    lambda_t: torch.Tensor   # (N + 1,) fp32: log alpha - log sigma
    x0_prev: Optional[torch.Tensor]  # the previous step's fp32 x0 (None before the first)
    step_count: int
    num_inference_steps: int


class UniPCMultistepScheduler(Scheduler):
    config_class = UniPCConfig

    def set_timesteps(self, num_inference_steps: int) -> UniPCState:
        acp = self.alphas_cumprod.numpy()
        ts = spaced_timesteps(self.config, num_inference_steps)
        a = np.sqrt(acp[ts])
        s = np.sqrt(1.0 - acp[ts])
        alpha_t = np.concatenate([a, [1.0]]).astype(np.float32)
        sigma_t = np.concatenate([s, [1e-9]]).astype(np.float32)
        lambda_t = np.log(alpha_t) - np.log(np.maximum(sigma_t, 1e-10))
        return UniPCState(torch.from_numpy(ts.copy()), torch.from_numpy(alpha_t),
                          torch.from_numpy(sigma_t), torch.from_numpy(lambda_t), None, 0,
                          num_inference_steps)

    def _to_x0(self, model_output, sample, alpha, sigma):
        pt = self.config.prediction_type
        if pt == "epsilon":
            return (sample - sigma * model_output) / alpha
        if pt == "v_prediction":
            return alpha * sample - sigma * model_output
        return model_output

    def step(self, state: UniPCState, model_output, i, sample):
        """One step in fp32; returns (prev_sample in sample's dtype, state
        with this step's x0 and the count advanced)."""
        s32 = sample.float()
        alpha, sigma = state.alpha_t[i], state.sigma_t[i]
        alpha_n, sigma_n = state.alpha_t[i + 1], state.sigma_t[i + 1]
        lam, lam_n = state.lambda_t[i], state.lambda_t[i + 1]
        x0 = self._to_x0(model_output.float(), s32, alpha, sigma)
        h = lam_n - lam
        prev = (sigma_n / sigma) * s32 - alpha_n * torch.expm1(-h) * x0
        use_first = state.step_count == 0 or self.config.solver_order < 2 or (
            self.config.lower_order_final and i == state.num_inference_steps - 1)
        if not use_first:
            lam_prev = state.lambda_t[max(i - 1, 0)]
            r = (lam - lam_prev) / h.clamp_min(1e-12)
            d1 = (x0 - state.x0_prev) / r.clamp_min(1e-8)
            prev = prev - 0.5 * alpha_n * torch.expm1(-h) * d1
        return prev.to(sample.dtype), state._replace(x0_prev=x0,
                                                     step_count=state.step_count + 1)
