"""CLIP text, vision and dual-tower configs (port of
paddlemix_tpu/models/clip/configuration.py), config.json round-trippable."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ...core.config import BaseConfig


@dataclasses.dataclass
class CLIPTextConfig(BaseConfig):
    model_type = "clip_text_model"
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    eos_token_id: int = 49407


@dataclasses.dataclass
class CLIPVisionConfig(BaseConfig):
    model_type = "clip_vision_model"
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    patch_bias: bool = False
    use_pre_layernorm: bool = True
    post_layernorm_full: bool = False  # post-LN over all tokens (Blip2), else CLS only

    def __post_init__(self):
        if not self.use_pre_layernorm or self.post_layernorm_full:
            raise NotImplementedError("CLIPVisionConfig: only the pre-LN tower with the "
                                      "post-LN on CLS (CLIP, LLaVA) is ported")


@dataclasses.dataclass
class CLIPConfig(BaseConfig):
    """The dual tower: the towers' configs as dicts, the shared projection
    width (which overrides the towers' own) and the initial logit scale."""

    model_type = "clip"
    text_config: Optional[Dict[str, Any]] = None
    vision_config: Optional[Dict[str, Any]] = None
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592

    def __post_init__(self):
        if self.text_config is None:
            self.text_config = {}
        if self.vision_config is None:
            self.vision_config = {}

    @property
    def text(self) -> CLIPTextConfig:
        return CLIPTextConfig.from_dict(dict(self.text_config,
                                             projection_dim=self.projection_dim))

    @property
    def vision(self) -> CLIPVisionConfig:
        return CLIPVisionConfig.from_dict(dict(self.vision_config,
                                               projection_dim=self.projection_dim))
