"""DPM-Solver++ multistep scheduler (port of `DPMSolverMultistepScheduler`
in paddlemix_tpu/diffusers/schedulers/scheduling_dpmsolver.py): the
data-prediction algorithm of order 1 or 2.

JAX's DPM-Solver++ step is, line for line, the order-2 predictor of its
UniPC (scheduling_unipc.py: the same tables, the first-order update, the
correction by the previous x0 over r = h_{i-1} / h_i with the expm1(-h) / 2
coefficient, the first and, with `lower_order_final`, the last step at first
order), but for UniPC's floor of 1e-12 under h, which no schedule's h comes
near. So the port runs `UniPCMultistepScheduler`'s step under DPM-Solver's
config. JAX applies `lower_order_final` at every step count; upstream's
DPM-Solver++ applies it below 15 steps only (ROADMAP C.38, kept).

JAX's config carries `algorithm_type` and `use_karras_sigmas`, which its
step never reads: the port takes their defaults and refuses any other value.
The singlestep variant is not ported.
"""

from __future__ import annotations

import dataclasses

from .scheduling_unipc import UniPCConfig, UniPCMultistepScheduler, UniPCState

DPMSolverState = UniPCState


@dataclasses.dataclass
class DPMSolverConfig(UniPCConfig):
    model_type = "dpmsolver++"
    algorithm_type: str = "dpmsolver++"
    use_karras_sigmas: bool = False

    def __post_init__(self):
        if self.algorithm_type != "dpmsolver++" or self.use_karras_sigmas:
            raise NotImplementedError(
                f"DPMSolverMultistepScheduler: algorithm_type {self.algorithm_type!r}, "
                f"use_karras_sigmas {self.use_karras_sigmas} not ported (the JAX package's step "
                f"is DPM-Solver++ over the config's timesteps and never reads them)")


class DPMSolverMultistepScheduler(UniPCMultistepScheduler):
    config_class = DPMSolverConfig
