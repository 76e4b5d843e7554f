from .common import Scheduler, SchedulerConfig, make_alphas_cumprod, spaced_timesteps
from .scheduling_euler import EulerConfig, EulerDiscreteScheduler, EulerState
from .scheduling_flow_match import FlowMatchConfig, FlowMatchEulerDiscreteScheduler, FlowMatchState

__all__ = ["EulerConfig", "EulerDiscreteScheduler", "EulerState", "FlowMatchConfig",
           "FlowMatchEulerDiscreteScheduler", "FlowMatchState", "Scheduler", "SchedulerConfig",
           "make_alphas_cumprod", "spaced_timesteps"]
