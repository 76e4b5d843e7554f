"""SDXL and SD3 text-to-image: models, Euler and FlowMatch schedulers, pipelines."""

from .image_processor import VaeImageProcessor
from .models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from .pipelines import DiffusionPipeline, StableDiffusion3Pipeline, StableDiffusionXLPipeline
from .schedulers import EulerDiscreteScheduler, FlowMatchEulerDiscreteScheduler

__all__ = ["AutoencoderKL", "AutoencoderKLConfig", "DiffusionPipeline",
           "EulerDiscreteScheduler", "FlowMatchEulerDiscreteScheduler", "SD3Transformer2DModel",
           "SD3TransformerConfig", "StableDiffusion3Pipeline", "StableDiffusionXLPipeline",
           "UNet2DConditionConfig", "UNet2DConditionModel", "VaeImageProcessor"]
