"""Tile plans of the wgmma GEMM core (csrc/gemm_wg.cuh), which the int8
a8w8 GEMM (B2, csrc/int8_gemm.cu), the weight-only int8 GEMM's tiled path
(B6, csrc/wint8_gemm.cu) and the int8 3x3 convs' implicit GEMM (B3 and B5,
csrc/int8_conv3x3.cu) run on, and a mirror of the core's persistent tile
walk.

A tile's A side is 128 rows (two consumer warpgroups of 64; the convs' 128 or
256 pixels), its reduction runs through stages 64 deep, and its other side is
the plan's `tile`:
  - B2: 128 rows of x by `tile` (256 or 128) weight rows, i.e. output
    columns; the walk's outer index is the row block, the inner one the
    column block.
  - B6 computes out^T = Wq x^T: 128 weight rows (output columns) by `tile`
    tokens (64, 128, 152, 208 or 256: wgmma's N); the walk's outer index is
    the weight block, the inner one the token block, so the token tiles of
    one weight tile run side by side and the weight is read from memory once.
  - B3 / B5: `pixels` (128 or 256) output pixels of one image (a TW x TH
    block, TW along W) by `tile` output channels (CONV_TILES); the walk's
    outer index is the pixel tile (image-major, then rows of tiles), the
    inner one the column block; the reduction runs through the 9 taps x
    64-channel chunks.
Blocks run in clusters of two whose tiles read the same rows of x, which
each block loads half of for both (TMA multicast): B2 pairs column blocks
(outer, 2i) and (outer, 2i + 1), B6 weight blocks (2o, inner) and (2o + 1,
inner); the convs pair column blocks (sharing the pixels' int8 map) unless
the plan pairs pixel tiles (sharing the weight), which it does where that
finishes sooner (an O of one column tile). Such a pair is a unit; unit u is
(u // unit_inner, u % unit_inner), cluster c of grid // 2 walks units c,
c + grid // 2, ..., and block b is rank b % 2 of cluster b // 2. Where the
paired count is odd, the last pair's second tile lies past the edge: its
block loads zeros, computes and stores nothing. The GEMMs' tile width is the
compiled one that finishes soonest by a simple model: waves (ceil(units /
clusters that fit at once)) times the width plus a fixed cost a tile (B2's
quantize of x, which every tile repeats, costs about what 64 more columns
do); the convs' by `_conv_cost`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Mapping, Tuple, Union

BLOCK_ROWS = 128  # the A side of a tile
BK = 64           # reduction depth of a stage
CLUSTER = 2       # blocks a cluster
H100_CLUSTERS = 66  # 2-block clusters an H100 SXM (132 SMs) runs at once
A8W8_TILES = (256, 128)
WINT8_TILES = (64, 128, 152, 208, 256)
# (output channels, pixels) of the convs' compiled tiles
CONV_TILES = ((160, 256), (128, 256), (160, 128))
PIXEL_TILES = (256, 128, 64, 32, 16, 8)  # a conv tile's pixels along W (at most `pixels`)
_TILE_COST = {"a8w8": 64, "wint8": 32}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Walked:
    """The persistent walk over (outer, inner) tiles in pairs, which every
    plan shares: needs outer_tiles, inner_tiles, pair_inner and grid."""

    @property
    def unit_inner(self) -> int:
        return _cdiv(self.inner_tiles, 2) if self.pair_inner else self.inner_tiles

    @property
    def units(self) -> int:
        outer = self.outer_tiles if self.pair_inner else _cdiv(self.outer_tiles, 2)
        return outer * self.unit_inner

    def tile_of(self, unit: int, rank: int) -> Tuple[int, int]:
        uo, ui = divmod(unit, self.unit_inner)
        return (uo, 2 * ui + rank) if self.pair_inner else (2 * uo + rank, ui)

    def in_range(self, outer: int, inner: int) -> bool:
        return outer < self.outer_tiles and inner < self.inner_tiles

    def walk(self) -> List[List[Tuple[int, int]]]:
        """The (outer, inner) tiles of each block, in the order it runs them
        (a pair's second tile past the edge included)."""
        clusters = self.grid // CLUSTER
        return [[self.tile_of(u, b % CLUSTER) for u in range(b // CLUSTER, self.units, clusters)]
                for b in range(self.grid)]


@dataclass(frozen=True)
class GemmPlan(_Walked):
    kernel: str       # "a8w8" (B2) or "wint8" (B6)
    m: int
    n: int
    k: int
    tile: int         # B2: output columns of a tile; B6: tokens of a tile
    outer_tiles: int
    inner_tiles: int
    grid: int         # blocks, CLUSTER a cluster

    @property
    def pair_inner(self) -> bool:
        return self.kernel == "a8w8"

    @property
    def k_blocks(self) -> int:
        return _cdiv(self.k, BK)

    def region(self, outer: int, inner: int) -> Tuple[slice, slice]:
        """(rows, columns) of `out` that tile (outer, inner) covers, clipped
        to (M, N) as the TMA store clips them."""
        if self.kernel == "a8w8":
            r0, c0, rows, cols = outer * BLOCK_ROWS, inner * self.tile, BLOCK_ROWS, self.tile
        else:
            r0, c0, rows, cols = inner * self.tile, outer * BLOCK_ROWS, self.tile, BLOCK_ROWS
        return slice(r0, min(r0 + rows, self.m)), slice(c0, min(c0 + cols, self.n))


@dataclass(frozen=True)
class ConvPlan(_Walked):
    """B3 / B5's plan for the 3x3 conv of a (b, h, w, c) map to o channels."""
    b: int
    h: int
    w: int
    c: int
    o: int
    tile: int         # output channels of a tile
    pixels: int       # output pixels of a tile: 64 a consumer warpgroup's m64 product
    tw: int           # pixels of a tile along W (PIXEL_TILES); th = pixels // tw rows
    pair_inner: bool  # a cluster: two column tiles of the same pixels (else the reverse)
    grid: int

    @property
    def th(self) -> int:
        return self.pixels // self.tw

    @property
    def tiles_w(self) -> int:
        return _cdiv(self.w, self.tw)

    @property
    def tiles_h(self) -> int:
        return _cdiv(self.h, self.th)

    @property
    def outer_tiles(self) -> int:
        return self.b * self.tiles_h * self.tiles_w

    @property
    def inner_tiles(self) -> int:
        return _cdiv(self.o, self.tile)

    @property
    def chunks(self) -> int:
        """64-channel chunks of C: a tap's stages."""
        return _cdiv(self.c, BK)

    @property
    def k_blocks(self) -> int:
        return 9 * self.chunks

    def origin(self, outer: int) -> Tuple[int, int, int]:
        """(image, top row, left column) of pixel tile `outer`."""
        b, r = divmod(outer, self.tiles_h * self.tiles_w)
        ty, tx = divmod(r, self.tiles_w)
        return b, ty * self.th, tx * self.tw

    def half(self, h: int) -> Tuple[int, int]:
        """(rows, columns) offset of half h (one consumer warpgroup's pixels)
        inside a tile: split along W when th = 1, else along H."""
        return (0, self.pixels // 2 * h) if self.th == 1 else (h * (self.th // 2), 0)

    def region(self, outer: int, inner: int) -> Tuple[int, slice, slice, slice]:
        """(image, rows, columns, channels) of `out` that tile (outer, inner)
        covers, clipped to the map and to O as the TMA store clips them."""
        b, y, x = self.origin(outer)
        c0 = inner * self.tile
        return (b, slice(y, min(y + self.th, self.h)), slice(x, min(x + self.tw, self.w)),
                slice(c0, min(c0 + self.tile, self.o)))


Clusters = Union[int, Mapping[int, int]]


def _fit(clusters: Clusters, tile) -> int:
    return max(1, clusters[tile] if isinstance(clusters, Mapping) else clusters)


def _conv_cost(plan: ConvPlan, fit: int) -> float:
    """A conv plan's time by a model of the H100's: waves of units times a
    stage's time, which the loads from L2 bound rather than the products
    (9 C is long, the tiles small): ~235 ns + 13 ns a KiB that a block
    receives a stage, 25% more with pixel tiles paired (each block loads its
    own A box, and half the weight's)."""
    a, wt = plan.pixels * BK, plan.tile * BK
    kib = (a / 2 + wt if plan.pair_inner else a + wt / 2) / 1024
    return _cdiv(plan.units, fit) * (235 + 13 * kib) * (1.0 if plan.pair_inner else 1.25)


def _plan(kernel: str, tiles: Tuple[int, ...], m: int, n: int, k: int,
          clusters: Clusters) -> GemmPlan:
    def plan(tile):
        outer, inner = ((_cdiv(m, BLOCK_ROWS), _cdiv(n, tile)) if kernel == "a8w8"
                        else (_cdiv(n, BLOCK_ROWS), _cdiv(m, tile)))
        return GemmPlan(kernel, m, n, k, tile, outer, inner, 0)

    def cost(tile):
        return _cdiv(plan(tile).units, _fit(clusters, tile)) * (tile + _TILE_COST[kernel])

    tile = min(tiles, key=cost)
    p = plan(tile)
    return GemmPlan(kernel, m, n, k, tile, p.outer_tiles, p.inner_tiles,
                    CLUSTER * min(p.units, _fit(clusters, tile)))


def a8w8_plan(m: int, n: int, k: int, clusters: Clusters = H100_CLUSTERS,
              tiles: Tuple[int, ...] = A8W8_TILES) -> GemmPlan:
    """B2's plan for x (m, k) @ wq (n, k)^T where `clusters` (one count, or
    one a tile width) 2-block clusters fit on the card at once, the tile
    width one of `tiles`."""
    return _plan("a8w8", tiles, m, n, k, clusters)


def wint8_plan(m: int, n: int, k: int, clusters: Clusters = H100_CLUSTERS,
               tiles: Tuple[int, ...] = WINT8_TILES) -> GemmPlan:
    """B6's tiled plan (m > 1) for x (m, k) @ wq (n, k)^T, `clusters` and
    `tiles` as in `a8w8_plan`."""
    return _plan("wint8", tiles, m, n, k, clusters)


def conv_plan(b: int, h: int, w: int, c: int, o: int, clusters: Clusters = H100_CLUSTERS,
              tiles: Tuple[Tuple[int, int], ...] = CONV_TILES,
              pairings: Tuple[bool, ...] = (True, False)) -> ConvPlan:
    """B3 / B5's plan: for each (columns, pixels) tile of `tiles`, the pixel
    block with the fewest tiles over the map (the widest on a tie); then the
    tile and the pairing of `pairings` (pair_inner first) that finish soonest
    by `_conv_cost`, where `clusters` 2-block clusters (one count, or one a
    tile of `tiles`) fit on the card at once."""
    def plan(tile, pixels, pair, grid=0):
        tw = min((t for t in PIXEL_TILES if t <= pixels),
                 key=lambda t: (_cdiv(w, t) * _cdiv(h, pixels // t), -t))
        return ConvPlan(b, h, w, c, o, tile, pixels, tw, pair, grid)

    def cost(choice):
        (tile, pixels), pair = choice
        return _conv_cost(plan(tile, pixels, pair), _fit(clusters, (tile, pixels)))

    (tile, pixels), pair = min(((t, p) for t in tiles for p in pairings), key=cost)
    p = plan(tile, pixels, pair)
    return plan(tile, pixels, pair, CLUSTER * min(p.units, _fit(clusters, (tile, pixels))))


@functools.lru_cache(maxsize=None)
def max_clusters(lib_name: str, fn_name: str, tiles: tuple, index: int):
    """{tile: 2-block clusters of that kernel that fit on CUDA device `index`
    at once}, from the library's `fn_name` (cudaOccupancyMaxActiveClusters),
    which takes the tile's int or, for a tuple, its ints."""
    import ctypes

    import torch

    from ..kernels import load_library

    fn = getattr(load_library(lib_name), fn_name)
    key = tiles[0]
    fn.argtypes = [ctypes.c_int] * (len(key) if isinstance(key, tuple) else 1)
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        counts = {tile: fn(*tile) if isinstance(tile, tuple) else fn(tile) for tile in tiles}
    if min(counts.values()) < 1:
        raise RuntimeError(f"{fn_name}: no 2-block cluster of {lib_name} fits on device "
                           f"{index}: {counts}")
    return counts
