"""SD1.5, SDXL and SD3 text-to-image: models, Euler, PNDM and FlowMatch schedulers,
pipelines; SD UNet training: the DDPM scheduler and the loss (training_utils)."""

from .image_processor import VaeImageProcessor
from .models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from .pipelines import (
    DiffusionPipeline,
    StableDiffusion3Pipeline,
    StableDiffusionPipeline,
    StableDiffusionXLPipeline,
)
from .schedulers import (
    DDPMScheduler,
    EulerDiscreteScheduler,
    FlowMatchEulerDiscreteScheduler,
    PNDMScheduler,
)

__all__ = ["AutoencoderKL", "AutoencoderKLConfig", "DDPMScheduler", "DiffusionPipeline",
           "EulerDiscreteScheduler", "FlowMatchEulerDiscreteScheduler", "PNDMScheduler",
           "SD3Transformer2DModel", "SD3TransformerConfig", "StableDiffusion3Pipeline",
           "StableDiffusionPipeline", "StableDiffusionXLPipeline",
           "UNet2DConditionConfig", "UNet2DConditionModel", "VaeImageProcessor"]
