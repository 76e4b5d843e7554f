"""Image conversion and resize primitives of the processors (port of
paddlemix_tpu/processors/image_utils.py, the host path: numpy and PIL).

The JAX package's on-device `jax_resize_normalize` is not ported. Arrays are
HWC; the processors emit NHWC float32 batches, the layout the port's vision
towers take.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
from PIL import Image

ImageInput = Union["Image.Image", np.ndarray]

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST,
            "lanczos": Image.LANCZOS}


def to_numpy_rgb(image: ImageInput) -> np.ndarray:
    """A PIL image, or an (H, W), (H, W, C) or (C, H, W) array -> (H, W, 3)."""
    if isinstance(image, Image.Image):
        return np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[0] in (1, 3) and arr.ndim == 3 and arr.shape[0] < arr.shape[-1]:
        arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr[..., :3]


def resize(image: np.ndarray, size: Tuple[int, int], resample: str = "bicubic") -> np.ndarray:
    """size: (height, width), by PIL (a non-uint8 array is cast to uint8 first,
    as the JAX package does)."""
    h, w = size
    pil = Image.fromarray(image if image.dtype == np.uint8 else image.astype(np.uint8))
    return np.asarray(pil.resize((w, h), _FILTERS[resample]))


def resize_shortest_edge(image: np.ndarray, shortest: int, resample: str = "bicubic") -> np.ndarray:
    """The short side to `shortest`, the long side scaled and TRUNCATED to an
    int (transformers' get_resize_output_image_size), not rounded."""
    h, w = image.shape[:2]
    short, long = (h, w) if h <= w else (w, h)
    new_long = int(shortest * long / short)
    nh, nw = (shortest, new_long) if h <= w else (new_long, shortest)
    return resize(image, (nh, nw), resample)


def center_crop(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The centred (ch, cw) window; zero-padded at the bottom and right where
    the image is smaller than the crop."""
    ch, cw = size
    h, w = image.shape[:2]
    top = max((h - ch) // 2, 0)
    left = max((w - cw) // 2, 0)
    out = image[top: top + ch, left: left + cw]
    if out.shape[0] != ch or out.shape[1] != cw:
        padded = np.zeros((ch, cw, image.shape[-1]), dtype=image.dtype)
        padded[: out.shape[0], : out.shape[1]] = out
        out = padded
    return out


def normalize(image: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    return (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
