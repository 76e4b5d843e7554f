"""SD1.5, SDXL, SD3 and PixArt-alpha text-to-image, DiT class-conditional
sampling: models, Euler, PNDM, DDIM, UniPC, DPM-Solver++ and FlowMatch
schedulers, pipelines, SD1.5 under a ControlNet or a T2I-Adapter; SD UNet
training: the DDPM scheduler and the loss (training_utils)."""

from .image_processor import VaeImageProcessor
from .models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    ControlNetConfig,
    ControlNetModel,
    DiTConfig,
    DiTModel,
    PixArtConfig,
    PixArtTransformer2DModel,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    T2IAdapter,
    T2IAdapterConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from .pipelines import (
    DiffusionPipeline,
    DiTPipeline,
    PixArtAlphaPipeline,
    StableDiffusion3Pipeline,
    StableDiffusionAdapterPipeline,
    StableDiffusionControlNetPipeline,
    StableDiffusionPipeline,
    StableDiffusionXLPipeline,
)
from .schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
    EulerDiscreteScheduler,
    FlowMatchEulerDiscreteScheduler,
    PNDMScheduler,
    UniPCMultistepScheduler,
)

__all__ = ["AutoencoderKL", "AutoencoderKLConfig", "ControlNetConfig", "ControlNetModel",
           "DDIMScheduler", "DDPMScheduler", "DPMSolverMultistepScheduler", "DiTConfig",
           "DiTModel", "DiTPipeline", "DiffusionPipeline", "EulerDiscreteScheduler",
           "FlowMatchEulerDiscreteScheduler", "PNDMScheduler", "PixArtAlphaPipeline",
           "PixArtConfig", "PixArtTransformer2DModel", "SD3Transformer2DModel",
           "SD3TransformerConfig", "StableDiffusion3Pipeline", "StableDiffusionAdapterPipeline",
           "StableDiffusionControlNetPipeline", "StableDiffusionPipeline",
           "StableDiffusionXLPipeline", "T2IAdapter", "T2IAdapterConfig", "UNet2DConditionConfig",
           "UNet2DConditionModel", "UniPCMultistepScheduler", "VaeImageProcessor"]
