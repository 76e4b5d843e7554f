"""Image processors (port of paddlemix_tpu/processors: the CLIP and BLIP-2
processors so far; the other models' processors are not ported, ROADMAP)."""

from .base import BaseImageProcessor, ProcessorMixin
from .blip_processing import Blip2Processor, BlipImageProcessor, BlipTextProcessor
from .clip_processing import CLIPImageProcessor, CLIPProcessor

__all__ = ["BaseImageProcessor", "Blip2Processor", "BlipImageProcessor", "BlipTextProcessor",
           "CLIPImageProcessor", "CLIPProcessor", "ProcessorMixin"]
