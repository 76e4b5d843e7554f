"""Tile plans of the wgmma GEMM core (csrc/gemm_wg.cuh), which the int8
a8w8 GEMM (B2, csrc/int8_gemm.cu) and the weight-only int8 GEMM's tiled path
(B6, csrc/wint8_gemm.cu) run on, and a mirror of the core's persistent tile
walk.

A tile's A side is 128 rows (two consumer warpgroups of 64), its reduction
runs through stages 64 deep, and its other side is the plan's `tile`:
  - B2: 128 rows of x by `tile` (256 or 128) weight rows, i.e. output
    columns; the walk's outer index is the row block, the inner one the
    column block.
  - B6 computes out^T = Wq x^T: 128 weight rows (output columns) by `tile`
    tokens (64, 128, 152, 208 or 256: wgmma's N); the walk's outer index is
    the weight block, the inner one the token block, so the token tiles of
    one weight tile run side by side and the weight is read from memory once.
Blocks run in clusters of two whose tiles read the same rows of x, which
each block loads half of for both (TMA multicast): B2 pairs column blocks
(outer, 2i) and (outer, 2i + 1), B6 weight blocks (2o, inner) and (2o + 1,
inner). Such a pair is a unit; unit u is (u // unit_inner, u % unit_inner),
cluster c of grid // 2 walks units c, c + grid // 2, ..., and block b is
rank b % 2 of cluster b // 2. Where the paired count is odd, the last pair's
second tile lies past the edge: its block loads zeros, computes and stores
nothing. The tile width is the compiled one that finishes soonest by a
simple model: waves (ceil(units / clusters that fit at once)) times the
width plus a fixed cost a tile (B2's quantize of x, which every tile
repeats, costs about what 64 more columns do).
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
_TILE_COST = {"a8w8": 64, "wint8": 32}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmPlan:
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
    def unit_inner(self) -> int:
        return _cdiv(self.inner_tiles, 2) if self.pair_inner else self.inner_tiles

    @property
    def units(self) -> int:
        outer = self.outer_tiles if self.pair_inner else _cdiv(self.outer_tiles, 2)
        return outer * self.unit_inner

    @property
    def k_blocks(self) -> int:
        return _cdiv(self.k, BK)

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

    def region(self, outer: int, inner: int) -> Tuple[slice, slice]:
        """(rows, columns) of `out` that tile (outer, inner) covers, clipped
        to (M, N) as the TMA store clips them."""
        if self.kernel == "a8w8":
            r0, c0, rows, cols = outer * BLOCK_ROWS, inner * self.tile, BLOCK_ROWS, self.tile
        else:
            r0, c0, rows, cols = inner * self.tile, outer * BLOCK_ROWS, self.tile, BLOCK_ROWS
        return slice(r0, min(r0 + rows, self.m)), slice(c0, min(c0 + cols, self.n))


Clusters = Union[int, Mapping[int, int]]


def _plan(kernel: str, tiles: Tuple[int, ...], m: int, n: int, k: int,
          clusters: Clusters) -> GemmPlan:
    def plan(tile):
        outer, inner = ((_cdiv(m, BLOCK_ROWS), _cdiv(n, tile)) if kernel == "a8w8"
                        else (_cdiv(n, BLOCK_ROWS), _cdiv(m, tile)))
        return GemmPlan(kernel, m, n, k, tile, outer, inner, 0)

    def fit(tile):
        return max(1, clusters[tile] if isinstance(clusters, Mapping) else clusters)

    def cost(tile):
        return _cdiv(plan(tile).units, fit(tile)) * (tile + _TILE_COST[kernel])

    tile = min(tiles, key=cost)
    p = plan(tile)
    return GemmPlan(kernel, m, n, k, tile, p.outer_tiles, p.inner_tiles,
                    CLUSTER * min(p.units, fit(tile)))


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


@functools.lru_cache(maxsize=None)
def max_clusters(lib_name: str, fn_name: str, tiles: Tuple[int, ...], index: int):
    """{tile: 2-block clusters of that kernel that fit on CUDA device `index`
    at once}, from the library's `fn_name` (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    import torch

    from ..kernels import load_library

    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        counts = {tile: fn(tile) for tile in tiles}
    if min(counts.values()) < 1:
        raise RuntimeError(f"{fn_name}: no 2-block cluster of {lib_name} fits on device "
                           f"{index}: {counts}")
    return counts
