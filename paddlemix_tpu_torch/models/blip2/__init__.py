"""BLIP-2 (OPT) captioning (port of paddlemix_tpu/models/blip2), and BLIP-2
OPT-2.7B at its published widths."""

from .configuration import Blip2Config, QFormerConfig
from .modeling import Blip2ForConditionalGeneration, QFormer, convert_hf_state_dict
from .opt27b import BLIP2_OPT_2_7B, expected_launches_blip2, random_blip2

__all__ = ["BLIP2_OPT_2_7B", "Blip2Config", "Blip2ForConditionalGeneration", "QFormer",
           "QFormerConfig", "convert_hf_state_dict", "expected_launches_blip2", "random_blip2"]
