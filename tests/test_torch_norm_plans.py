"""The plans of csrc/norms.cu's kernels, as their Python mirrors in
paddlemix_tpu_torch.ops.norms give them: GroupNorm's (B4, `group_norm_plan`)
at every shape the paths give it, from walks of the models (SDXL's UNet and
VAE in bf16 and under static a8w8, whose resnets take B5's statistics, SD1.5's,
SD1.5 training's and SD3's VAE) and the card checks' shape lists, and the
LayerNorm backward's (B10, `layer_norm_bwd_plan`). Each plan holds whole
groups in 16-byte slab rows within the card's limits, takes the on-chip form
wherever its clusters fit the card at once, and its walk covers every (row,
channel) or row exactly once; sums taken in the walk's order agree with the
plain versions within fp32 rounding.

Inputs are made with numpy from a seed.
"""

import functools
import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    CLIP_LN_SHAPES,
    EVA_LN_SHAPES,
    FUSED_CASES,
    FUSED_RAGGED,
    GN_CASES,
    GN_RAGGED,
    LN_WIDE_EXTRA_CASES,
    SD15_GN_CASES,
    SD15_TRAIN_BATCH,
    SD15_TRAIN_GN_CASES,
)
from paddlemix_tpu_torch.diffusers import sd3, sd15, sdxl
from paddlemix_tpu_torch.ops import norms as tn

pytestmark = pytest.mark.torch_port

SMEM_LIMIT = 227 * 1024


@functools.lru_cache(maxsize=None)
def _walk(path):
    """(wrapper, (B, H, W, C)) of every GroupNorm call a path makes."""
    if path == "sdxl":
        calls = sdxl.unet_group_norm_calls(sdxl.SDXL_UNET, 2, 128) + \
            sdxl.vae_group_norm_calls(sdxl.SDXL_VAE, 128)
    elif path == "sdxl_a8w8":
        calls = sdxl.unet_group_norm_calls(sdxl.SDXL_UNET, 2, 128, fused=True) + \
            sdxl.vae_group_norm_calls(sdxl.SDXL_VAE, 128, fused=True)
    elif path == "sd15":
        calls = sdxl.unet_group_norm_calls(sd15.SD15_UNET, 2, 64) + \
            sdxl.vae_group_norm_calls(sd15.SD15_VAE, 64)
    elif path == "sd15_train":
        calls = sdxl.unet_group_norm_calls(sd15.SD15_UNET, SD15_TRAIN_BATCH, 64)
    else:
        calls = sdxl.vae_group_norm_calls(sd3.SD3_VAE, 128)
    return sorted({(name, shape) for name, shape, _ in calls})


def _listed():
    """(wrapper, shape) of the card checks' lists."""
    gn = [s for s, _ in GN_CASES + SD15_GN_CASES + SD15_TRAIN_GN_CASES] + [GN_RAGGED]
    stats = [s for s, _, _ in FUSED_CASES] + [FUSED_RAGGED[0]]
    return sorted({("group_norm", s) for s in gn} | {("group_norm_stats", s) for s in stats})


def _check_plan(name, shape, esize, groups=32):
    b, c, n = shape[0], shape[-1], math.prod(shape[1:-1])
    stats = name == "group_norm_stats"
    plan = tn.group_norm_plan(b, n, c, groups, esize, stats=stats)
    assert plan is not None
    cpg = c // groups
    # a slab of whole groups, its row a multiple of 16 bytes, read 16 bytes a load
    assert c % plan.slab == 0 and plan.slab % cpg == 0
    assert plan.slab * esize % 16 == 0 and plan.vec * esize == 16
    assert 1 <= plan.cluster <= tn._MAX_CLUSTER and plan.cluster & (plan.cluster - 1) == 0
    assert plan.smem <= SMEM_LIMIT
    clusters = b * (c // plan.slab)
    if plan.form == tn.RESIDENT:
        assert not stats and plan.launches() == 1
        tile = plan.tile_bytes(esize)
        assert tile <= tn.GN_TILE_MAX and plan.rows * plan.slab * esize <= tile
        assert _cdiv(plan.rows, plan.box) <= tn.GN_HEAD // 8 and plan.box <= tn.GN_BOX_ROWS
        assert clusters <= tn._gn_capacity(plan.cluster, plan.smem)
    else:
        assert plan.launches(stats) == (1 if stats else 2)
        assert clusters <= tn.GN_STATS_CAPACITY[plan.cluster.bit_length() - 1] or plan.cluster == 1
        if not stats:  # no cluster size the plan could take holds the map at once
            most = _cdiv(n, tn.GN_MIN_ROWS) if n < tn.GN_MIN_ROWS * 16 else 16
            top = 1
            while top * 2 <= most and top < _cdiv(tn.GN_TARGET_BLOCKS, clusters):
                top *= 2
            cl = top
            while cl >= 1:
                rows = _cdiv(n, cl)
                box = (rows + 7) // 8 * 8 if rows < tn.GN_BOX_ROWS else tn.GN_BOX_ROWS
                tile = _cdiv(rows, box) * box * plan.slab * esize
                smem = tn._gn_smem(tile, tn.GN_THREADS, plan.slab, cpg)
                assert tile > tn.GN_TILE_MAX or clusters > tn._gn_capacity(cl, smem), (cl, plan)
                cl //= 2
    # every (row, channel) exactly once: the blocks are rectangles, each slab
    # of each batch once, its rows split without gap or overlap
    spans = {}
    for bb, c0, rank, lo, hi in plan.blocks(b, n, c):
        assert lo == min(n, rank * plan.rows) and hi == min(n, lo + plan.rows)
        spans.setdefault((bb, c0), []).append((lo, hi))
    assert sorted(spans) == [(bb, c0) for bb in range(b) for c0 in range(0, c, plan.slab)]
    for runs in spans.values():
        runs = [r for r in runs if r[1] > r[0]]
        assert runs[0][0] == 0 and runs[-1][1] == n
        assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))
    return plan


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("path", ["sdxl", "sdxl_a8w8", "sd15", "sd15_train", "sd3_vae"])
def test_group_norm_plans_at_the_paths_shapes(path, esize):
    calls = _walk(path)
    assert calls and all(len(s) == 4 for _, s in calls)
    for name, shape in calls:
        _check_plan(name, shape, esize)


@pytest.mark.parametrize("name, shape", _listed(), ids=[f"{n}-{'x'.join(map(str, s))}"
                                                       for n, s in _listed()])
def test_group_norm_plans_at_the_listed_shapes(name, shape):
    _check_plan(name, shape, 2)


def test_group_norm_plan_forms():
    """The on-chip form where the clusters fit the card at once, the re-read
    form at the maps that do not (SDXL's 128 x 128 widths, the VAE's large
    maps)."""
    form = lambda s: tn.group_norm_plan(s[0], s[1] * s[2], s[3], 32, 2).form  # noqa: E731
    for s in [(2, 32, 32, 640), (2, 32, 32, 1280), (8, 8, 8, 1280), (2, 64, 64, 320),
              (1, 64, 64, 512), (8, 64, 64, 320), GN_RAGGED]:
        assert form(s) == tn.RESIDENT, s
    for s in [(2, 128, 128, 320), (2, 128, 128, 960), (2, 64, 64, 960), (1, 256, 256, 256),
              (1, 512, 512, 128), (1, 1024, 1024, 128), (8, 64, 64, 960)]:
        assert form(s) == tn.REREAD, s
    assert tn.group_norm_plan(1, 4, 30, 32, 2) is None  # channels not a multiple of groups
    assert tn.group_norm_plan(1, 64, 4096 * 8, 1, 2) is None  # one group of 4096 loads


def _group_norm_planned(x, w, b, groups, eps, act, plan):
    """GroupNorm with its sums taken in the plan's order: each block's channel
    sums over its rows, their group sums, then the cluster's blocks in rank
    order; fp32 throughout."""
    bsz, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xr = x.reshape(bsz, -1, c).float()
    n = xr.shape[1]
    parts = {}
    for bb, c0, rank, lo, hi in plan.blocks(bsz, n, c):
        t = xr[bb, lo:hi, c0:c0 + plan.slab]
        parts[bb, c0, rank] = torch.stack([t.sum(0).reshape(-1, cpg).sum(1),
                                           (t * t).sum(0).reshape(-1, cpg).sum(1)])
    mean = torch.empty(bsz, groups)
    rstd = torch.empty(bsz, groups)
    for (bb, c0, rank), _ in sorted(parts.items()):
        if rank:
            continue
        tot = parts[bb, c0, 0].clone()
        for r in range(1, plan.cluster):
            tot = tot + parts[bb, c0, r]
        m = tot[0] / (n * cpg)
        var = torch.clamp(tot[1] / (n * cpg) - m * m, min=0.0)
        g0 = c0 // cpg
        mean[bb, g0:g0 + len(m)] = m
        rstd[bb, g0:g0 + len(m)] = 1.0 / torch.sqrt(var + eps)
    scale = rstd.repeat_interleave(cpg, -1) * w.float()
    shift = b.float() - mean.repeat_interleave(cpg, -1) * scale
    y = xr * scale[:, None] + shift[:, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape), (mean, rstd)


@pytest.mark.parametrize("shape, act", [((2, 8, 8, 320), "silu"), ((1, 50, 100, 96), "silu"),
                                        ((2, 16, 16, 960), "none"), ((1, 30, 30, 128), "silu")])
def test_group_norm_sums_in_the_plan_order_match_the_plain_version(shape, act):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * rng.uniform(0.5, 2.0, c)
                          + rng.standard_normal(c)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    for stats in (False, True):
        plan = tn.group_norm_plan(shape[0], shape[1] * shape[2], c, 32, 2, stats=stats)
        y, (mean, rstd) = _group_norm_planned(x, w, b, 32, 1e-5, act, plan)
        ref = tn.group_norm_ref(x, w, b, 32, 1e-5, act)
        rmean, rrstd = tn._group_moments(x, 32, 1e-5)
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=0)


LN_CASES = [(r, h) for r, h, _ in CLIP_LN_SHAPES] + [(1000, 200), (3000, 100), (1025, 768)]


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows, h", LN_CASES, ids=[f"{r}x{h}" for r, h in LN_CASES])
def test_layer_norm_bwd_plan_walk(rows, h, esize):
    plan = tn.layer_norm_bwd_plan(rows, h, esize)
    assert plan.smem <= SMEM_LIMIT and 1 <= plan.cluster <= tn._MAX_CLUSTER
    assert plan.epl % 8 == 0 and plan.epl * 32 >= h and plan.epl <= 40
    if h * esize % 16 == 0:
        assert plan.vec * esize == 16 and 2 <= plan.stages <= 4
    else:
        assert plan.vec == 1 and plan.stages == 0
    if rows <= tn.LN_SINGLE_ROWS:
        assert plan.clusters == 1  # the sums never leave the chip
    else:
        assert plan.cluster == tn.LN_CLUSTER and plan.clusters * plan.cluster == tn.LN_BLOCKS
    blocks = plan.cluster * plan.clusters
    seen = np.zeros(rows, dtype=np.int32)
    for k in range(blocks):
        for w in range(plan.warps):
            seen[plan.warp_rows(k, w, rows).start:plan.warp_rows(k, w, rows).stop] += 1
    assert (seen == 1).all()
    # the partial rows: cluster q's rows, contiguous and in order
    spans = [plan.cluster_rows(q, rows) for q in range(plan.clusters)]
    assert spans[0].start == 0 and spans[-1].stop == rows
    assert all(a.stop == b.start for a, b in zip(spans, spans[1:]))


WIDE_CASES = [(r, h) for r, h, _ in EVA_LN_SHAPES] + [s for s, _, _ in LN_WIDE_EXTRA_CASES] + \
    [(1025, 2048), (1, 1281)]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "one-element"])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows, h", WIDE_CASES, ids=[f"{r}x{h}" for r, h in WIDE_CASES])
def test_layer_norm_bwd_wide_plan_walk(rows, h, esize, aligned):
    """Rows wider than 1,280 (EVA's ffn_ln): the wide form, 64 elements a
    lane, one block an SM (its shared memory above half the SM's), a ring
    of 1-4 rows a warp within 128 KB plus w in lane order, one cluster of at
    most 8 blocks up to 1,024 rows, else LN_WIDE_BLOCKS in clusters of 4;
    every row walked once."""
    plan = tn.layer_norm_bwd_plan(rows, h, esize, aligned)
    vec = 16 // esize if aligned and h * esize % 16 == 0 else 1
    assert plan.vec == vec and plan.epl == tn.LN_WIDE_EPL and plan.epl * 32 >= h
    assert SMEM_LIMIT // 2 < plan.smem <= SMEM_LIMIT
    row = (h * esize + 15) // 16 * 16
    if vec > 1:
        assert 1 <= plan.stages <= 4 and plan.warps * plan.stages * 2 * row <= tn.LN_WIDE_RING_BYTES
    else:
        assert plan.stages == 0
    assert plan.smem == max(plan.warps * plan.stages * 2 * row + 32 * plan.epl * 4,
                            plan.warps * 64 * plan.epl * 4)
    if rows <= tn.LN_SINGLE_ROWS:
        assert plan.clusters == 1 and plan.cluster <= tn.LN_WIDE_CLUSTER
    else:
        assert plan.cluster == tn.LN_CLUSTER and \
            plan.clusters * plan.cluster == tn.LN_WIDE_BLOCKS
    seen = np.zeros(rows, dtype=np.int32)
    for k in range(plan.cluster * plan.clusters):
        for w in range(plan.warps):
            r = plan.warp_rows(k, w, rows)
            seen[r.start:r.stop] += 1
    assert (seen == 1).all()
    # a row of at most 1,280 keeps the held form and its plan
    held = tn.layer_norm_bwd_plan(rows, 1280, esize, aligned)
    assert held.epl <= tn.LN_HOLD_EPL and (held.vec > 1 or held.epl == tn.LN_HOLD_EPL)
    assert tn.layer_norm_bwd_plan(rows, 2049, esize, aligned) is None


def _layer_norm_bwd_planned(x, w, g, eps, plan):
    """The backward with dw and db summed in the plan's order: each warp over
    its rows, the block's warps, the cluster's blocks by rank, the clusters."""
    rows, h = x.shape
    dx = torch.empty_like(x)
    parts = []
    for q in range(plan.clusters):
        cl_sum = None
        for rank in range(plan.cluster):
            k = q * plan.cluster + rank
            blk = None
            for wp in range(plan.warps):
                acc = torch.zeros(2, h)
                for r in plan.warp_rows(k, wp, rows):
                    d, dw, db = tn.layer_norm_backward_ref(x[r:r + 1], w, g[r:r + 1], eps)
                    dx[r] = d[0]
                    acc = acc + torch.stack([dw, db])
                blk = acc if blk is None else blk + acc
            cl_sum = blk if cl_sum is None else cl_sum + blk
        parts.append(cl_sum)
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return dx, tot[0], tot[1]


@pytest.mark.parametrize("rows, h", [(77, 64), (300, 40), (1100, 24), (1100, 1288)])
def test_layer_norm_bwd_sums_in_the_plan_order_match_the_plain_version(rows, h):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((rows, h)) * rng.uniform(0.5, 3, (rows, 1))
                          + rng.standard_normal((rows, 1))).astype(np.float32))
    w = torch.from_numpy((1 + 0.2 * rng.standard_normal(h)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, h)).astype(np.float32))
    plan = tn.layer_norm_bwd_plan(rows, h, 4)
    dx, dw, db = _layer_norm_bwd_planned(x, w, g, 1e-5, plan)
    rdx, rdw, rdb = tn.layer_norm_backward_ref(x, w, g, 1e-5)
    torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, rdb, rtol=1e-5, atol=1e-4)
