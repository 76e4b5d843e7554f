"""InternVL2's dynamic tiling, on the host (port of
paddlemix_tpu/processors/internvl_processing.py).

An image is split into up to `max_num` 448 px tiles on the grid whose aspect
ratio is closest to the image's, plus a thumbnail where there is more than
one tile (`dynamic_preprocess`); MiniMonkey's multi-scale form adds a
second, complementary grid (`minimonkey_preprocess`). The processor's output
is the JAX package's, bit for bit: each image's tiles normalized and padded
with zero tiles to `pad_to_tiles` (13), with the mask of the real ones and
their count. The padding is the JAX package's static-shape bucket (one
compiled program serves every image); the port's model runs only the tiles
the mask marks (models/internvl2/modeling.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .base import BaseImageProcessor
from .image_utils import IMAGENET_MEAN, IMAGENET_STD, normalize, resize, to_numpy_rgb


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios: Sequence[Tuple[int, int]],
                              width: int, height: int, image_size: int) -> Tuple[int, int]:
    """The (cols, rows) of `target_ratios` closest to `aspect_ratio`; on a tie
    the later one where the image's area exceeds half the grid's."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        diff = abs(aspect_ratio - ratio[0] / ratio[1])
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff and area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
            best = ratio
    return best


def _target_ratios(min_num: int, max_num: int):
    return sorted({(i, j) for n in range(min_num, max_num + 1)
                   for i in range(1, n + 1) for j in range(1, n + 1)
                   if min_num <= i * j <= max_num}, key=lambda x: x[0] * x[1])


def _tile(image: np.ndarray, ratio, image_size: int, use_thumbnail: bool) -> List[np.ndarray]:
    tw, th = image_size * ratio[0], image_size * ratio[1]
    resized = resize(image.astype(np.uint8), (th, tw))
    cols = tw // image_size
    tiles = []
    for i in range(ratio[0] * ratio[1]):
        x0 = (i % cols) * image_size
        y0 = (i // cols) * image_size
        tiles.append(resized[y0: y0 + image_size, x0: x0 + image_size])
    if use_thumbnail and len(tiles) > 1:
        tiles.append(resize(image.astype(np.uint8), (image_size, image_size)))
    return tiles


def dynamic_preprocess(image: np.ndarray, min_num: int = 1, max_num: int = 12,
                       image_size: int = 448, use_thumbnail: bool = True) -> List[np.ndarray]:
    """The image's tiles (row-major) on the closest grid of min_num-max_num
    tiles, and a thumbnail of the whole image where there is more than one."""
    h, w = image.shape[:2]
    ratio = find_closest_aspect_ratio(w / h, _target_ratios(min_num, max_num), w, h, image_size)
    return _tile(image, ratio, image_size, use_thumbnail)


def dynamic_preprocess2(image: np.ndarray, min_num: int = 1, max_num: int = 6,
                        image_size: int = 448, use_thumbnail: bool = False,
                        prior_aspect_ratio: Tuple[int, int] = (1, 1)) -> List[np.ndarray]:
    """MiniMonkey's complementary second tiling: among the grids whose columns
    and rows both divide neither of `prior_aspect_ratio`'s (all of them where
    none does), the closest."""
    h, w = image.shape[:2]
    target = _target_ratios(min_num, max_num)
    complementary = [r for r in target
                     if prior_aspect_ratio[0] % r[0] != 0
                     and prior_aspect_ratio[1] % r[1] != 0] or target
    ratio = find_closest_aspect_ratio(w / h, complementary, w, h, image_size)
    return _tile(image, ratio, image_size, use_thumbnail)


def minimonkey_preprocess(image: np.ndarray, image_size: int = 448, min_num: int = 3,
                          max_num: int = 7, min_num2: int = 2, max_num2: int = 3
                          ) -> List[np.ndarray]:
    """MiniMonkey's two-pass tiling: the detail pass on the closest grid of
    min_num-max_num tiles, the complementary coarse pass, then the first
    pass's thumbnail last."""
    h, w = image.shape[:2]
    ratio1 = find_closest_aspect_ratio(w / h, _target_ratios(min_num, max_num), w, h,
                                       image_size)
    tiles = dynamic_preprocess(image, min_num, max_num, image_size, use_thumbnail=True)
    tiles2 = dynamic_preprocess2(image, min_num2, max_num2, image_size, use_thumbnail=False,
                                 prior_aspect_ratio=ratio1)
    return tiles[:-1] + tiles2 + tiles[-1:] if len(tiles) > 1 else tiles + tiles2


@dataclasses.dataclass
class InternVLImageProcessor(BaseImageProcessor):
    model_type = "internvl_image_processor"
    image_size: int = 448
    min_num: int = 1
    max_num: int = 12
    use_thumbnail: bool = True
    pad_to_tiles: int = 13  # the JAX package's static bucket (max_num + thumbnail)
    multi_scale: bool = False  # MiniMonkey's two-pass tiling
    image_mean: Tuple[float, ...] = IMAGENET_MEAN
    image_std: Tuple[float, ...] = IMAGENET_STD

    def __call__(self, images) -> dict:
        """{"pixel_values": (B, pad_to_tiles, H, W, 3) float32, "tile_mask":
        (B, pad_to_tiles) int32, "num_tiles": (B,) int32}."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        all_tiles, masks, counts = [], [], []
        for im in images:
            arr = to_numpy_rgb(im)
            if self.multi_scale:
                tiles = minimonkey_preprocess(arr, self.image_size, max_num=self.max_num)
            else:
                tiles = dynamic_preprocess(arr, self.min_num, self.max_num, self.image_size,
                                           self.use_thumbnail)
            n = len(tiles)
            tiles = [normalize(t.astype(np.float32) / 255.0, self.image_mean, self.image_std)
                     for t in tiles]
            while len(tiles) < self.pad_to_tiles:
                tiles.append(np.zeros_like(tiles[0]))
            all_tiles.append(np.stack(tiles[: self.pad_to_tiles]))
            masks.append([1] * min(n, self.pad_to_tiles) + [0] * max(self.pad_to_tiles - n, 0))
            counts.append(n)
        return {"pixel_values": np.stack(all_tiles),
                "tile_mask": np.asarray(masks, np.int32),
                "num_tiles": np.asarray(counts, np.int32)}


def pixel_unshuffle(x: np.ndarray, scale_factor: float = 0.5) -> np.ndarray:
    """InternVL's pixel unshuffle of (B, H, W, C) features on the host."""
    b, h, w, c = x.shape
    r = int(1 / scale_factor)
    x = x.reshape(b, h // r, r, w // r, r, c).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, c * r * r)
