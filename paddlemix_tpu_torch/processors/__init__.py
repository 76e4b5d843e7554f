"""Image processors (port of paddlemix_tpu/processors: the CLIP processor
so far; the other models' processors are not ported, ROADMAP)."""

from .base import BaseImageProcessor, ProcessorMixin
from .clip_processing import CLIPImageProcessor, CLIPProcessor

__all__ = ["BaseImageProcessor", "CLIPImageProcessor", "CLIPProcessor", "ProcessorMixin"]
