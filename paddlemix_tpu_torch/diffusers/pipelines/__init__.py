from .pipeline_utils import (
    PIPELINE_REGISTRY,
    DiffusionPipeline,
    make_scheduler_state,
    register_pipeline,
)
from .stable_diffusion import StableDiffusionPipeline, StableDiffusionXLPipeline
from .controlnet import StableDiffusionControlNetPipeline
from .stable_diffusion_3 import DiTPipeline, StableDiffusion3Pipeline
from .pixart_alpha import PixArtAlphaPipeline
from .t2i_adapter import StableDiffusionAdapterPipeline

__all__ = ["PIPELINE_REGISTRY", "DiTPipeline", "DiffusionPipeline", "PixArtAlphaPipeline",
           "StableDiffusion3Pipeline",
           "StableDiffusionAdapterPipeline", "StableDiffusionControlNetPipeline",
           "StableDiffusionPipeline", "StableDiffusionXLPipeline", "make_scheduler_state",
           "register_pipeline"]
