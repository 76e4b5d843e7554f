"""Processor base classes (port of paddlemix_tpu/processors/base.py): an
image processor's config round trip through preprocessor_config.json, and
the bundle of an image processor and a tokenizer."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

from ..core.config import BaseConfig, resolve_file


@dataclasses.dataclass
class BaseImageProcessor(BaseConfig):
    config_name = "preprocessor_config.json"

    def __call__(self, images, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


class ProcessorMixin:
    """An image processor and a tokenizer together."""

    image_processor_class = None  # the dataclass `from_pretrained` loads

    def __init__(self, image_processor=None, tokenizer=None, **components):
        self.image_processor = image_processor
        self.tokenizer = tokenizer
        for k, v in components.items():
            setattr(self, k, v)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs):
        """The image processor from preprocessor_config.json (defaults where
        there is none) and a CLIP BPE tokenizer where vocab.json and
        merges.txt are there (the JAX package's `load_tokenizer` also reads
        tokenizer.json and vocab.txt tokenizers, which are not ported)."""
        from ..models.clip.tokenizer import CLIPTokenizer

        image_processor = None
        if cls.image_processor_class is not None:
            try:
                image_processor = cls.image_processor_class.from_pretrained(path)
            except FileNotFoundError:
                image_processor = cls.image_processor_class()
        tokenizer = None
        if resolve_file(path, "vocab.json", required=False) and \
                resolve_file(path, "merges.txt", required=False):
            tokenizer = CLIPTokenizer.from_pretrained(path)
        return cls(image_processor=image_processor, tokenizer=tokenizer, **kwargs)

    def save_pretrained(self, path: str):
        os.makedirs(path, exist_ok=True)
        if self.image_processor is not None:
            self.image_processor.save_pretrained(path)
