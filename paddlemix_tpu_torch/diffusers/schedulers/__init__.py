from .common import Scheduler, SchedulerConfig, make_alphas_cumprod, spaced_timesteps
from .scheduling_euler import EulerConfig, EulerDiscreteScheduler, EulerState
from .scheduling_flow_match import FlowMatchConfig, FlowMatchEulerDiscreteScheduler, FlowMatchState
from .scheduling_pndm import PNDMConfig, PNDMScheduler, PNDMState

__all__ = ["EulerConfig", "EulerDiscreteScheduler", "EulerState", "FlowMatchConfig",
           "FlowMatchEulerDiscreteScheduler", "FlowMatchState", "PNDMConfig", "PNDMScheduler",
           "PNDMState", "Scheduler", "SchedulerConfig",
           "make_alphas_cumprod", "spaced_timesteps"]
