"""SD1.5, SDXL and SD3 text-to-image: models, Euler, PNDM, DDIM, UniPC and FlowMatch
schedulers, pipelines, SD1.5 under a ControlNet or a T2I-Adapter; SD UNet
training: the DDPM scheduler and the loss (training_utils)."""

from .image_processor import VaeImageProcessor
from .models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    ControlNetConfig,
    ControlNetModel,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    T2IAdapter,
    T2IAdapterConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from .pipelines import (
    DiffusionPipeline,
    StableDiffusion3Pipeline,
    StableDiffusionAdapterPipeline,
    StableDiffusionControlNetPipeline,
    StableDiffusionPipeline,
    StableDiffusionXLPipeline,
)
from .schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    EulerDiscreteScheduler,
    FlowMatchEulerDiscreteScheduler,
    PNDMScheduler,
    UniPCMultistepScheduler,
)

__all__ = ["AutoencoderKL", "AutoencoderKLConfig", "ControlNetConfig", "ControlNetModel",
           "DDIMScheduler", "DDPMScheduler", "DiffusionPipeline", "EulerDiscreteScheduler",
           "FlowMatchEulerDiscreteScheduler", "PNDMScheduler", "SD3Transformer2DModel",
           "SD3TransformerConfig", "StableDiffusion3Pipeline", "StableDiffusionAdapterPipeline",
           "StableDiffusionControlNetPipeline", "StableDiffusionPipeline",
           "StableDiffusionXLPipeline", "T2IAdapter", "T2IAdapterConfig", "UNet2DConditionConfig",
           "UNet2DConditionModel", "UniPCMultistepScheduler", "VaeImageProcessor"]
