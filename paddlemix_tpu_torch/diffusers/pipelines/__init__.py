from .pipeline_utils import DiffusionPipeline, make_scheduler_state
from .stable_diffusion import StableDiffusionPipeline, StableDiffusionXLPipeline
from .stable_diffusion_3 import StableDiffusion3Pipeline

__all__ = ["DiffusionPipeline", "StableDiffusion3Pipeline", "StableDiffusionPipeline",
           "StableDiffusionXLPipeline", "make_scheduler_state"]
