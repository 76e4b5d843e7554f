"""Qwen2-VL configs (port of paddlemix_tpu/models/qwen2_vl/modeling.py
`Qwen2VLVisionConfig`, `Qwen2VLConfig`), config.json round-trippable: a
JAX- or HF-written config.json loads with its other keys kept in
`unused_kwargs`. The vision config's `hidden_act` is not read: the tower's
MLP runs exact GELU (ROADMAP C.16).

The published config.json (Qwen/Qwen2-VL-7B-Instruct, written by
transformers 4.41) has no `text_config`: the language model's fields sit at
the top level, the M-RoPE sections in `rope_scaling["mrope_section"]` and
the tower's channels in `vision_config["in_chans"]`. JAX reads
`text_config` alone and so builds a Llama-7B-shaped model for that file
(ROADMAP C.22). The port departs from it there: where `text_config` is
absent, `Qwen2VLConfig.from_dict` takes the language model's fields from the
top level, `mrope_section` from `rope_scaling` and `in_channels` from
`in_chans`. A config with a `text_config` (JAX's, the port's) reads as JAX
reads it. `published_config_dict` writes the published layout."""

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

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **overrides) -> "Qwen2VLConfig":
        """As `BaseConfig.from_dict`; a published-layout dict (no
        `text_config`) is read as the module docstring says."""
        data = dict(data, **overrides)
        if data.get("text_config") is None:
            own = {f.name for f in dataclasses.fields(cls)}
            text_fields = {f.name for f in dataclasses.fields(LlamaConfig)} - own
            data["text_config"] = {k: v for k, v in data.items() if k in text_fields}
            section = (data.get("rope_scaling") or {}).get("mrope_section")
            if section is not None and "mrope_section" not in data:
                data["mrope_section"] = tuple(section)
            vision = dict(data.get("vision_config") or {})
            if "in_chans" in vision:
                vision.setdefault("in_channels", vision.pop("in_chans"))
            data["vision_config"] = vision
        return super().from_dict(data)

    @property
    def vision(self) -> Qwen2VLVisionConfig:
        return Qwen2VLVisionConfig.from_dict(self.vision_config)

    @property
    def text(self) -> LlamaConfig:
        """The language model: a Llama with q / k / v biases (Qwen2) at this
        config's rope_theta."""
        return LlamaConfig.from_dict(dict(self.text_config, attention_bias=True,
                                          rope_theta=self.rope_theta))


def published_config_dict(config: Qwen2VLConfig) -> Dict[str, Any]:
    """`config` in the published config.json layout (transformers 4.41's
    Qwen2-VL): the language model's fields at the top level beside
    `rope_theta`, `rope_scaling` {"type": "mrope", "mrope_section"}, the
    token ids, and `vision_config` with `in_chans`. `Qwen2VLConfig.from_dict`
    reads it back to an equal config."""
    vision = dict(config.vision_config)
    if "in_channels" in vision:
        vision["in_chans"] = vision.pop("in_channels")
    return dict(config.text_config, architectures=["Qwen2VLForConditionalGeneration"],
                model_type="qwen2_vl", image_token_id=config.image_token_id,
                video_token_id=config.video_token_id,
                vision_start_token_id=config.vision_start_token_id,
                rope_theta=config.rope_theta,
                rope_scaling={"type": "mrope", "mrope_section": list(config.mrope_section)},
                vision_config=vision)
