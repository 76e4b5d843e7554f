"""LLaVA-1.5 (port of paddlemix_tpu/models/llava), and the 7B bench model."""

from .llava7b import bench_input_ids, expected_launches_llava, llava7b_config, random_llava
from .modeling import (LlavaConfig, LlavaForConditionalGeneration, LlavaModule, MMProjector,
                       llava_loss)

__all__ = ["LlavaConfig", "LlavaForConditionalGeneration", "LlavaModule", "MMProjector",
           "bench_input_ids", "expected_launches_llava", "llava7b_config", "llava_loss",
           "random_llava"]
