from .configuration import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from .eva import EVACLIP, EVACLIPConfig, EVAVisionConfig, EVAVisionTransformer
from .modeling import (
    CLIPModel,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    CLIPTextTransformer,
    CLIPVisionModel,
    CLIPVisionTransformer,
    clip_contrastive_loss,
    scaled_logits,
)
from .tokenizer import CLIPTokenizer

__all__ = ["CLIPConfig", "CLIPModel", "CLIPTextConfig", "CLIPTextModel",
           "CLIPTextModelWithProjection", "CLIPTextTransformer", "CLIPTokenizer",
           "CLIPVisionConfig", "CLIPVisionModel", "CLIPVisionTransformer", "EVACLIP",
           "EVACLIPConfig", "EVAVisionConfig", "EVAVisionTransformer",
           "clip_contrastive_loss", "scaled_logits"]
