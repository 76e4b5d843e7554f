"""Image processors (port of paddlemix_tpu/processors: the CLIP, BLIP-2 and
Qwen2-VL processors so far; the other models' processors are not ported,
ROADMAP)."""

from .base import BaseImageProcessor, ProcessorMixin
from .blip_processing import Blip2Processor, BlipImageProcessor, BlipTextProcessor
from .clip_processing import CLIPImageProcessor, CLIPProcessor
from .qwen2_vl_processing import Qwen2VLImageProcessor, Qwen2VLProcessor

__all__ = ["BaseImageProcessor", "Blip2Processor", "BlipImageProcessor", "BlipTextProcessor",
           "CLIPImageProcessor", "CLIPProcessor", "ProcessorMixin", "Qwen2VLImageProcessor",
           "Qwen2VLProcessor"]
