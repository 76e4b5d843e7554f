from .pipeline_utils import (
    PIPELINE_REGISTRY,
    DiffusionPipeline,
    make_scheduler_state,
    register_pipeline,
)
from .stable_diffusion import StableDiffusionPipeline, StableDiffusionXLPipeline
from .stable_diffusion_3 import StableDiffusion3Pipeline

__all__ = ["PIPELINE_REGISTRY", "DiffusionPipeline", "StableDiffusion3Pipeline",
           "StableDiffusionPipeline", "StableDiffusionXLPipeline", "make_scheduler_state",
           "register_pipeline"]
