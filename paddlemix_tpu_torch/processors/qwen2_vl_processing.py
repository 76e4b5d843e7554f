"""Qwen2-VL dynamic-resolution processing, on the host (port of
paddlemix_tpu/processors/qwen2_vl_processing.py).

Each image is resized by `smart_resize` to multiples of patch x merge (28)
within a pixel budget, cut into 3 x 2 x 14 x 14 patches (an image doubled in
time, a video's frames in pairs) in merge-grouped order (each 2 x 2 block of
patches consecutive, as the vision tower's PatchMerger reads them), and given
its patches' (h, w) rotary positions. The images of a request are packed
into one sequence, each its own attention segment, padded to a multiple of
`pad_to_multiple` rows with segment 0 (the JAX package's static bucket; the
pads attend among themselves and their merged rows are never spliced in).
numpy and PIL only, as the JAX package's host path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .base import BaseImageProcessor
from .image_utils import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, normalize, resize, to_numpy_rgb


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """(height, width) rounded to multiples of `factor`, scaled into
    [min_pixels, max_pixels]; sides under `factor` are first scaled up to it.
    Raises for an aspect ratio above 200."""
    if height < factor or width < factor:
        scale = factor / min(height, width)
        height, width = math.ceil(height * scale), math.ceil(width * scale)
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def vision_patch_positions(grid_thw: Sequence[Tuple[int, int, int]],
                           merge_size: int = 2) -> np.ndarray:
    """(patches, 2) int: each patch's (row, column) in merge-grouped order,
    repeated over the temporal groups (the upstream `rot_pos_emb` order)."""
    out = []
    for t, h, w in grid_thw:
        hpos = np.arange(h)[:, None].repeat(w, axis=1)
        wpos = np.arange(w)[None, :].repeat(h, axis=0)

        def perm(a):
            return a.reshape(h // merge_size, merge_size, w // merge_size,
                             merge_size).transpose(0, 2, 1, 3).reshape(-1)

        out.append(np.tile(np.stack([perm(hpos), perm(wpos)], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def extract_patches(image: np.ndarray, patch_size: int = 14, merge_size: int = 2,
                    temporal_patch_size: int = 2) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """An (H, W, C) image or a (T, H, W, C) video -> ((patches, C * tp * ps *
    ps) float32 in merge-grouped order, (temporal groups, rows, columns) of
    patches). An image is repeated over the temporal patch; a video is padded
    to a multiple of it by repeating its last frame."""
    tp = temporal_patch_size
    if image.ndim == 3:
        frames = np.stack([image] * tp)
    else:
        frames = image
        if frames.shape[0] % tp:
            pad = tp - frames.shape[0] % tp
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    t_groups = frames.shape[0] // tp
    h, w = frames.shape[1:3]
    gh, gw = h // patch_size, w // patch_size
    c = frames.shape[-1]
    m = merge_size
    out = []
    for g in range(t_groups):
        x = frames[g * tp: (g + 1) * tp].reshape(tp, gh, patch_size, gw, patch_size, c)
        x = x.transpose(1, 3, 0, 2, 4, 5)  # (gh, gw, tp, ps, ps, C)
        x = x.reshape(gh // m, m, gw // m, m, tp, patch_size, patch_size, c)
        x = x.transpose(0, 2, 1, 3, 4, 7, 5, 6)  # (gh/m, gw/m, m, m, tp, C, ps, ps)
        out.append(x.reshape(gh * gw, c * tp * patch_size * patch_size))
    return np.concatenate(out).astype(np.float32), (t_groups, gh, gw)


def smart_nframes(total_frames: int, fps: float = 2.0, video_fps: float = 30.0,
                  min_frames: int = 4, max_frames: int = 768,
                  temporal_patch_size: int = 2) -> int:
    """How many frames to sample from a video of `total_frames` at
    `video_fps`: `fps` a second within [min_frames, max_frames], rounded to
    a multiple of the temporal patch."""
    n = total_frames / video_fps * fps
    n = min(max(n, min_frames), max_frames, total_frames)
    return max(int(round(n / temporal_patch_size)) * temporal_patch_size, temporal_patch_size)


@dataclasses.dataclass
class Qwen2VLImageProcessor(BaseImageProcessor):
    model_type = "qwen2_vl_image_processor"
    patch_size: int = 14
    merge_size: int = 2
    temporal_patch_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 14 * 14 * 4 * 1280
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD
    do_normalize: bool = True
    pad_to_multiple: int = 256  # the packed patches' static bucket

    def __call__(self, images) -> dict:
        """One image or a list -> pixel_patches (1, P, 1176) float32,
        patch_pos_hw (1, P, 2) int32, patch_segments (1, P) int32 (image i
        is segment i + 1, pads 0), image_grid_thw (images, 3) int64 and
        num_patches (the unpadded count). Each image is read as (H, W, 3):
        the JAX processor has no video entry (ROADMAP C.19)."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        all_patches, grids = [], []
        for im in images:
            arr = to_numpy_rgb(im).astype(np.float32)
            h, w = arr.shape[:2]
            nh, nw = smart_resize(h, w, self.patch_size * self.merge_size, self.min_pixels,
                                  self.max_pixels)
            arr = resize(arr.astype(np.uint8), (nh, nw)).astype(np.float32) / 255.0
            if self.do_normalize:
                arr = normalize(arr, self.image_mean, self.image_std)
            patches, grid = extract_patches(arr, self.patch_size, self.merge_size,
                                            self.temporal_patch_size)
            all_patches.append(patches)
            grids.append(grid)
        pixel = np.concatenate(all_patches, axis=0)
        grid_thw = np.asarray(grids, np.int64)
        pos_hw = vision_patch_positions(grids, self.merge_size)
        segments = np.concatenate([np.full((g[0] * g[1] * g[2],), i + 1, np.int32)
                                   for i, g in enumerate(grids)])
        n = pixel.shape[0]
        bucket = max(self.pad_to_multiple, self.merge_size ** 2)
        padded = -(-n // bucket) * bucket
        if padded != n:
            pixel = np.pad(pixel, ((0, padded - n), (0, 0)))
            pos_hw = np.pad(pos_hw, ((0, padded - n), (0, 0)))
            segments = np.pad(segments, (0, padded - n))
        return {
            "pixel_patches": pixel[None],
            "patch_pos_hw": pos_hw[None].astype(np.int32),
            "patch_segments": segments[None],
            "image_grid_thw": grid_thw,
            "num_patches": n,
        }


class Qwen2VLProcessor:
    """The image processor and a tokenizer: each `<|image_pad|>` of the text
    becomes one placeholder a merged patch of its image. Without a tokenizer
    (Qwen2's tokenizer files are not in the repository) it returns the
    placeholder counts, `num_image_tokens`, beside the image outputs."""

    image_placeholder = "<|image_pad|>"

    def __init__(self, image_processor: Optional[Qwen2VLImageProcessor] = None,
                 tokenizer=None, image_token_id: int = 151655):
        self.image_processor = image_processor or Qwen2VLImageProcessor()
        self.tokenizer = tokenizer
        self.image_token_id = image_token_id

    def __call__(self, text: str, images=None, **kwargs) -> dict:
        out = {}
        n_placeholder_tokens = []
        if images is not None:
            out = self.image_processor(images)
            m4 = self.image_processor.merge_size ** 2
            n_placeholder_tokens = [int(np.prod(g)) // m4 for g in out["image_grid_thw"]]
        if self.tokenizer is not None:
            for n in n_placeholder_tokens:
                text = text.replace(self.image_placeholder, "<IMG>" * n, 1)
            out.update(self.tokenizer(text, **kwargs))
        else:
            out["num_image_tokens"] = n_placeholder_tokens
        return out
