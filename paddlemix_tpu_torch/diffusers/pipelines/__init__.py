from .pipeline_utils import (
    PIPELINE_REGISTRY,
    DiffusionPipeline,
    make_scheduler_state,
    register_pipeline,
)
from .stable_diffusion import StableDiffusionPipeline, StableDiffusionXLPipeline
from .controlnet import StableDiffusionControlNetPipeline
from .stable_diffusion_3 import StableDiffusion3Pipeline
from .t2i_adapter import StableDiffusionAdapterPipeline

__all__ = ["PIPELINE_REGISTRY", "DiffusionPipeline", "StableDiffusion3Pipeline",
           "StableDiffusionAdapterPipeline", "StableDiffusionControlNetPipeline",
           "StableDiffusionPipeline", "StableDiffusionXLPipeline", "make_scheduler_state",
           "register_pipeline"]
