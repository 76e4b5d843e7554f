from .configuration import CLIPTextConfig, CLIPVisionConfig
from .modeling import (
    CLIPTextModel,
    CLIPTextModelWithProjection,
    CLIPTextTransformer,
    CLIPVisionModel,
    CLIPVisionTransformer,
)
from .tokenizer import CLIPTokenizer

__all__ = ["CLIPTextConfig", "CLIPTextModel", "CLIPTextModelWithProjection",
           "CLIPTextTransformer", "CLIPTokenizer", "CLIPVisionConfig", "CLIPVisionModel",
           "CLIPVisionTransformer"]
