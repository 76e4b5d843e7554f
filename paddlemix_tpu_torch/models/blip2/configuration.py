"""BLIP-2 configs (copies of paddlemix_tpu/models/blip2/modeling.py
`QFormerConfig` and `Blip2Config`), config.json round-trippable: an HF
Blip2 config.json loads, its other keys kept in `unused_kwargs`.

The OPT branch with the HF-format CLIP tower is ported
(`vision_tower="clip"`, `lm_type="opt"`, the JAX defaults); the EVA ViT-g
tower and the FlanT5 branch raise, naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ...core.config import BaseConfig
from ..clip.configuration import CLIPVisionConfig
from ..opt.configuration import OPTConfig


@dataclasses.dataclass
class QFormerConfig(BaseConfig):
    model_type = "blip_2_qformer"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass
class Blip2Config(BaseConfig):
    model_type = "blip-2"
    vision_config: Optional[Dict[str, Any]] = None
    qformer_config: Optional[Dict[str, Any]] = None
    text_config: Optional[Dict[str, Any]] = None
    num_query_tokens: int = 32
    lm_type: str = "opt"  # "opt" | "t5" (FlanT5)
    vision_tower: str = "clip"  # "clip": the HF-format tower | "eva": the EVA ViT-g

    def __post_init__(self):
        self.vision_config = dict(self.vision_config or {})
        self.qformer_config = dict(self.qformer_config or {})
        self.text_config = dict(self.text_config or {})
        if self.vision_tower == "eva":
            raise NotImplementedError("Blip2Config: the EVA ViT-g tower (vision_tower='eva') "
                                      "is not ported (ROADMAP A.2, BLIP-2 leftovers)")
        if self.lm_type == "t5":
            raise NotImplementedError("Blip2Config: the FlanT5 branch (lm_type='t5') is not "
                                      "ported: the port has no T5 decoder (ROADMAP A.2, BLIP-2 "
                                      "leftovers)")
        if self.vision_tower != "clip" or self.lm_type != "opt":
            raise ValueError(f"Blip2Config: vision_tower {self.vision_tower!r} / lm_type "
                             f"{self.lm_type!r}")

    @property
    def vision(self) -> CLIPVisionConfig:
        """BLIP-2's form of the CLIP tower: a biased patch embedding, no
        pre-LN, the post-LN over every token."""
        return CLIPVisionConfig.from_dict(dict(self.vision_config, patch_bias=True,
                                               use_pre_layernorm=False,
                                               post_layernorm_full=True))

    @property
    def qformer(self) -> QFormerConfig:
        return QFormerConfig.from_dict(self.qformer_config)

    @property
    def text(self) -> OPTConfig:
        return OPTConfig.from_dict(self.text_config)
