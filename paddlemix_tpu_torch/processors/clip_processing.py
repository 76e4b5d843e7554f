"""CLIP image and text processing (port of
paddlemix_tpu/processors/clip_processing.py): resize the shortest edge,
centre crop, rescale, normalise, as NHWC float32 batches.

Two paths, kept as the JAX package has them. The default path resizes with
PIL (bicubic by default) and truncates the long side. With
PMIX_NATIVE_PREPROCESS=1 the native C++ path resizes BILINEARLY and ROUNDS
the long side, fused with the normalisation, then crops: its pixels differ
from the default path's (ROADMAP, faults of the reference). Where that path
is asked for and its library does not build, the call raises (the JAX
package falls back silently to the default path).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from .base import BaseImageProcessor, ProcessorMixin
from .image_utils import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    center_crop,
    normalize,
    resize_shortest_edge,
    to_numpy_rgb,
)


@dataclasses.dataclass
class CLIPImageProcessor(BaseImageProcessor):
    model_type = "clip_image_processor"
    do_resize: bool = True
    size: int = 224
    resample: str = "bicubic"
    do_center_crop: bool = True
    crop_size: int = 224
    do_rescale: bool = True
    rescale_factor: float = 1 / 255.0
    do_normalize: bool = True
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD

    def __call__(self, images) -> dict:
        """One image or a list -> {"pixel_values": (N, S, S, 3) float32}."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        native = None
        if os.environ.get("PMIX_NATIVE_PREPROCESS", "") == "1" and self.do_resize \
                and self.do_rescale and self.do_normalize:
            from .. import native
        out = []
        for im in images:
            arr = to_numpy_rgb(im)
            if native is not None:
                out.append(self._native(native, arr))
                continue
            if self.do_resize:
                arr = resize_shortest_edge(arr, self.size, self.resample)
            if self.do_center_crop:
                arr = center_crop(arr, (self.crop_size, self.crop_size))
            arr = arr.astype(np.float32)
            if self.do_rescale:
                arr = arr * self.rescale_factor
            if self.do_normalize:
                arr = normalize(arr, self.image_mean, self.image_std)
            out.append(arr)
        return {"pixel_values": np.stack(out)}

    def _native(self, native, arr):
        """The fused C++ path: bilinear resize of the shortest edge to `size`
        (both sides rounded) with the normalisation, then the crop."""
        h, w = arr.shape[:2]
        s = self.size / min(h, w)
        arr = native.resize_normalize(arr.astype(np.uint8), (round(h * s), round(w * s)),
                                      self.image_mean, self.image_std, self.rescale_factor)
        if self.do_center_crop:
            arr = native.center_crop(arr, (self.crop_size, self.crop_size))
        return arr


class CLIPProcessor(ProcessorMixin):
    image_processor_class = CLIPImageProcessor

    @classmethod
    def from_pretrained(cls, path: str, **kwargs):
        """preprocessor_config.json and the BPE tokenizer files of `path`."""
        from ..models.clip.tokenizer import CLIPTokenizer

        return cls(image_processor=CLIPImageProcessor.from_pretrained(path),
                   tokenizer=CLIPTokenizer.from_pretrained(path))

    def __call__(self, text=None, images=None, **kwargs):
        out = {}
        if images is not None:
            out.update(self.image_processor(images))
        if text is not None:
            out.update(self.tokenizer(text, **kwargs))
        return out
