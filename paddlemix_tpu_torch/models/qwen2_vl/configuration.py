"""Qwen2-VL configs (port of paddlemix_tpu/models/qwen2_vl/modeling.py
`Qwen2VLVisionConfig`, `Qwen2VLConfig`), config.json round-trippable: a
JAX- or HF-written config.json loads with its other keys kept in
`unused_kwargs`. As in the JAX package, `mrope_section` and `rope_theta` are
read from the config's own fields (HF's `rope_scaling` is not read), and the
vision config's `hidden_act` is not read: the tower's MLP runs exact GELU
(ROADMAP C.16)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ...core.config import BaseConfig
from ..llama.configuration import LlamaConfig


@dataclasses.dataclass
class Qwen2VLVisionConfig(BaseConfig):
    model_type = "qwen2_vl_vision"
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: float = 4.0
    hidden_size: int = 3584  # the merged features' width: the language model's

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


@dataclasses.dataclass
class Qwen2VLConfig(BaseConfig):
    model_type = "qwen2_vl"
    vision_config: Optional[Dict[str, Any]] = None
    text_config: Optional[Dict[str, Any]] = None
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)

    def __post_init__(self):
        self.vision_config = dict(self.vision_config or {})
        self.text_config = dict(self.text_config or {})

    @property
    def vision(self) -> Qwen2VLVisionConfig:
        return Qwen2VLVisionConfig.from_dict(self.vision_config)

    @property
    def text(self) -> LlamaConfig:
        """The language model: a Llama with q / k / v biases (Qwen2) at this
        config's rope_theta."""
        return LlamaConfig.from_dict(dict(self.text_config, attention_bias=True,
                                          rope_theta=self.rope_theta))
