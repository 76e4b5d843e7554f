"""PNDM scheduler, skip-prk variant, the SD1.x default (port of
paddlemix_tpu/diffusers/schedulers/scheduling_pndm.py): linear multistep over
the last four epsilons.

As in the JAX package, and unlike diffusers' `step_plms`, each of the N steps
is one model call: the multistep starts at order 1 on the first epsilon and
rises to order 4, so N steps take N UNet calls (diffusers averages the first
two epsilons and steps twice from the first timestep: N + 1 calls).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .common import Scheduler, SchedulerConfig, spaced_timesteps


@dataclasses.dataclass
class PNDMConfig(SchedulerConfig):
    model_type = "pndm"
    skip_prk_steps: bool = True
    set_alpha_to_one: bool = False


class PNDMState(NamedTuple):
    timesteps: torch.Tensor       # (N,) int64 on the host, descending
    prev_timesteps: torch.Tensor  # (N,) int64: timesteps - num_train // N (the last < 0)
    ets: Tuple[torch.Tensor, ...]  # the last (at most 4) fp32 epsilons, newest last
    num_inference_steps: int


class PNDMScheduler(Scheduler):
    config_class = PNDMConfig

    def __init__(self, config=None, **kwargs):
        super().__init__(config, **kwargs)
        if not self.config.skip_prk_steps:
            raise NotImplementedError("PNDMScheduler: only skip_prk_steps=True is ported (the "
                                      "JAX package implements that variant alone)")
        if self.config.prediction_type != "epsilon":
            raise NotImplementedError(f"PNDMScheduler: prediction_type "
                                      f"{self.config.prediction_type!r} is not ported (epsilon)")

    def set_timesteps(self, num_inference_steps: int) -> PNDMState:
        ts = spaced_timesteps(self.config, num_inference_steps)
        step = self.config.num_train_timesteps // num_inference_steps
        return PNDMState(torch.from_numpy(ts.copy()), torch.from_numpy(ts - step), (),
                         num_inference_steps)

    def _prev_sample(self, sample, t: int, prev_t: int, eps):
        """The PNDM transfer formula (reference `_get_prev_sample`), fp32."""
        acp = self.alphas_cumprod
        a_t = acp[t]
        a0 = torch.tensor(1.0) if self.config.set_alpha_to_one else acp[0]
        a_prev = acp[prev_t] if prev_t >= 0 else a0
        sample_coeff = torch.sqrt(a_prev / a_t)
        denom = a_t * torch.sqrt(1.0 - a_prev) + torch.sqrt(a_t * a_prev * (1.0 - a_t))
        eps_coeff = (a_prev - a_t) / denom
        return sample_coeff.to(sample.device) * sample - eps_coeff.to(sample.device) * eps

    def step(self, state: PNDMState, model_output, i, sample):
        """One linear-multistep step in fp32; returns (prev_sample in sample's
        dtype, state with the epsilon appended)."""
        ets = (state.ets + (model_output.float(),))[-4:]
        e = ets[::-1]  # newest first
        if len(e) == 1:
            eps = e[0]
        elif len(e) == 2:
            eps = (3 * e[0] - e[1]) / 2
        elif len(e) == 3:
            eps = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
        else:
            eps = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24
        prev = self._prev_sample(sample.float(), int(state.timesteps[i]),
                                 int(state.prev_timesteps[i]), eps)
        return prev.to(sample.dtype), state._replace(ets=ets)
