"""Image processors (port of paddlemix_tpu/processors: the CLIP, BLIP-2,
Qwen2-VL, InternVL2 and Qwen-VL processors so far; the other models'
processors are not ported, ROADMAP)."""

from .base import BaseImageProcessor, ProcessorMixin
from .blip_processing import Blip2Processor, BlipImageProcessor, BlipTextProcessor
from .clip_processing import CLIPImageProcessor, CLIPProcessor
from .internvl_processing import InternVLImageProcessor
from .qwen2_vl_processing import Qwen2VLImageProcessor, Qwen2VLProcessor
from .qwen_vl_processing import QwenVLImageProcessor, QwenVLProcessor

__all__ = ["BaseImageProcessor", "Blip2Processor", "BlipImageProcessor", "BlipTextProcessor",
           "CLIPImageProcessor", "CLIPProcessor", "InternVLImageProcessor", "ProcessorMixin",
           "Qwen2VLImageProcessor", "Qwen2VLProcessor", "QwenVLImageProcessor", "QwenVLProcessor"]
