from .common import Scheduler, SchedulerConfig, make_alphas_cumprod, spaced_timesteps
from .scheduling_ddim import DDIMConfig, DDIMScheduler, DDIMState
from .scheduling_ddpm import DDPMConfig, DDPMScheduler, DDPMState
from .scheduling_euler import EulerConfig, EulerDiscreteScheduler, EulerState
from .scheduling_flow_match import FlowMatchConfig, FlowMatchEulerDiscreteScheduler, FlowMatchState
from .scheduling_pndm import PNDMConfig, PNDMScheduler, PNDMState
from .scheduling_unipc import UniPCConfig, UniPCMultistepScheduler, UniPCState

__all__ = ["DDIMConfig", "DDIMScheduler", "DDIMState", "DDPMConfig", "DDPMScheduler", "DDPMState",
           "EulerConfig", "EulerDiscreteScheduler", "EulerState", "FlowMatchConfig",
           "FlowMatchEulerDiscreteScheduler", "FlowMatchState", "PNDMConfig", "PNDMScheduler",
           "PNDMState", "Scheduler", "SchedulerConfig", "UniPCConfig", "UniPCMultistepScheduler",
           "UniPCState", "make_alphas_cumprod", "spaced_timesteps"]
