from .configuration import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
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
           "CLIPVisionConfig", "CLIPVisionModel", "CLIPVisionTransformer",
           "clip_contrastive_loss", "scaled_logits"]
