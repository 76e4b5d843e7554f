from .attention import (
    AttentionBlock2D,
    BasicTransformerBlock,
    CrossAttention,
    GEGLUFeedForward,
    Transformer2DModel,
)
from .autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from .embeddings import (
    PatchEmbed2D,
    TimestepEmbedding,
    Timesteps,
    get_2d_sincos_pos_embed,
    get_timestep_embedding,
)
from .resnet import Downsample2D, GroupNormAct, ResnetBlock2D, Upsample2D
from .transformer_sd3 import JointTransformerBlock, SD3Transformer2DModel, SD3TransformerConfig
from .unet_2d_condition import UNet2DConditionConfig, UNet2DConditionModel

__all__ = [
    "AttentionBlock2D", "AutoencoderKL", "AutoencoderKLConfig", "BasicTransformerBlock",
    "CrossAttention", "Downsample2D", "GEGLUFeedForward", "GroupNormAct", "JointTransformerBlock",
    "PatchEmbed2D", "ResnetBlock2D", "SD3Transformer2DModel", "SD3TransformerConfig",
    "TimestepEmbedding", "Timesteps", "Transformer2DModel", "UNet2DConditionConfig",
    "UNet2DConditionModel", "Upsample2D", "get_2d_sincos_pos_embed", "get_timestep_embedding",
]
