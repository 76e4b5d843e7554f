"""The tile plans and tiled plain versions of the port's int8 3x3 convs (B3
`int8_conv3x3_same`, B5 `fused_gn_silu_conv3x3`), which run as an activation
pass into an int8 map, then an int8 implicit GEMM on the wgmma core
(csrc/int8_conv3x3.cu, csrc/gemm_wg.cuh): the walk covers every output pixel
and channel once at the smoke's shapes, at every compiled tile width, both
pairings and two cluster counts; the tiled plain versions, which walk the
kernel's pixel tiles and (tap, 64-channel chunk) stages over zero-filled
boxes, equal the plain versions bit for bit and agree with the JAX package's
Pallas kernels run in interpret mode; the activation pass's plain version is
the quantize inside the plain fused version.

Inputs are made with numpy from a seed.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from chip_smoke import CONV_RAGGED, CONV_SHAPES, FUSED_CASES, FUSED_RAGGED
from paddlemix_tpu_torch.ops import conv_int8 as tci
from paddlemix_tpu_torch.ops import fused_resnet as tfr
from paddlemix_tpu_torch.ops import gemm_tiles as gt
from paddlemix_tpu_torch.ops.quant import static_scale

pytestmark = pytest.mark.torch_port

# (B, H, W, C, O) of the smoke's B3 and B5 cases, ragged ones included
SMOKE_CONVS = [s + (s[-1],) for s in CONV_SHAPES] + [CONV_RAGGED] \
    + [shape + (o,) for shape, o, _ in FUSED_CASES + [FUSED_RAGGED]]
# small maps at SDXL's widths (a tile of 128 x 1, 64 x 2 and 32 x 4 pixels),
# and ragged ones: W no power of two, B*H*W no multiple of 128, O = 8 mod 16,
# C no multiple of the 64-channel chunk
SMALL = [(1, 2, 128, 32, 40), (2, 3, 64, 48, 24), (1, 5, 32, 16, 56), (1, 9, 13, 16, 8),
         (1, 7, 100, 80, 200)]


def _plans(shape, clusters):
    """The plan at every compiled tile (columns, pixels) and both pairings."""
    return [gt.conv_plan(*shape, clusters, tiles=(tile,), pairings=(pair,))
            for tile in gt.CONV_TILES for pair in (True, False)]


@pytest.mark.parametrize("clusters", [gt.H100_CLUSTERS, 5], ids=["h100", "five_clusters"])
@pytest.mark.parametrize("shape", SMOKE_CONVS + SMALL, ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_covers_every_output_once(shape, clusters):
    b, h, w, c, o = shape
    for plan in _plans(shape, clusters):
        assert plan.grid % gt.CLUSTER == 0 and plan.grid <= gt.CLUSTER * clusters
        assert plan.th * plan.tw == plan.pixels and plan.k_blocks == 9 * -(-c // gt.BK)
        walked = [t for block in plan.walk() for t in block]
        real = [t for t in walked if plan.in_range(*t)]
        assert sorted(real) == [(t, i) for t in range(plan.outer_tiles)
                                for i in range(plan.inner_tiles)]
        # the only tiles past the edge: a pair's second one where the paired count is odd
        paired = plan.inner_tiles if plan.pair_inner else plan.outer_tiles
        other = plan.outer_tiles if plan.pair_inner else plan.inner_tiles
        assert len(walked) - len(real) == other * (paired % 2)
        # the two blocks of a cluster share their A box (pixels) or their weight (columns)
        blocks = plan.walk()
        for k in range(0, plan.grid, gt.CLUSTER):
            for t0, t1 in zip(blocks[k], blocks[k + 1]):
                assert t0[0] == t1[0] if plan.pair_inner else t0[1] == t1[1]
        # pixel tiles partition the map, column tiles the channels; the two
        # halves of a tile (one consumer warpgroup's pixels each) split it
        pixels = np.zeros((b, h, w), dtype=np.int32)
        for t in range(plan.outer_tiles):
            bi, rows, xs, _ = plan.region(t, 0)
            pixels[bi, rows, xs] += 1
        assert (pixels == 1).all()
        channels = np.zeros(o, dtype=np.int32)
        for i in range(plan.inner_tiles):
            channels[plan.region(0, i)[3]] += 1
        assert (channels == 1).all()
        halves = {plan.half(0), plan.half(1)}
        assert len(halves) == 2 and all(dy * plan.tw + dx == plan.pixels // 2 * k
                                        for k, (dy, dx) in enumerate(sorted(halves)))


def test_conv_plans_at_the_smoke_shapes():
    """The (columns, pixels, TW, pairing) the cost model picks on an H100 (66
    clusters of 2), the fastest of every variant at these shapes on the card:
    256-pixel tiles, 160 columns at O = 320 / 640 / 1280, 128-pixel tiles
    where 256 would leave a second wave nearly empty (32x32 maps), pixel
    tiles paired where O is one column tile."""
    picks = {s: (p.tile, p.pixels, p.tw, p.pair_inner) for s in SMOKE_CONVS
             for p in [gt.conv_plan(*s)]}
    assert picks[(2, 64, 64, 1280, 1280)] == (160, 256, 64, True)
    assert picks[(2, 128, 128, 640, 640)] == (160, 256, 128, True)
    assert picks[(1, 512, 512, 512, 512)] == (128, 256, 256, True)
    assert picks[(1, 1024, 1024, 256, 256)] == (128, 256, 256, True)
    assert picks[(2, 128, 128, 320, 320)] == (160, 256, 128, True)
    assert picks[(2, 32, 32, 1280, 1280)] == (160, 128, 32, True)
    assert picks[(2, 64, 64, 640, 640)] == (160, 256, 64, True)
    assert picks[(1, 1024, 1024, 128, 128)] == (128, 256, 256, False)


def _conv_inputs(rs, b, h, w, c, o):
    x = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(torch.bfloat16)
    wq, sw = tci.quantize_weight_per_cout(torch.from_numpy(
        (rs.randn(o, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)))
    bias = torch.from_numpy((0.1 * rs.randn(o)).astype(np.float32))
    return x, tci.conv3x3_weight_layout(wq), sw, static_scale(x.float().abs().max().item()), bias


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
def test_conv_tiled_ref_is_bit_exact(shape):
    x, wq, sw, sx, bias = _conv_inputs(np.random.RandomState(7), *shape)
    for b in (bias, None):
        ref = tci.int8_conv3x3_same_ref(x, wq, sw, sx, b)
        for plan in _plans(shape, 5):
            out = tci.int8_conv3x3_tiled_ref(x, wq, sw, sx, b, plan=plan)
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert torch.equal(out, ref)  # int32 sums in any order, the same fp32 epilogue


def _fused_inputs(rs, b, h, w, c, o, affine_dtype):
    x, wq, sw, _, bias = _conv_inputs(rs, b, h, w, c, o)
    gamma = torch.from_numpy((1.0 + 0.1 * rs.randn(c)).astype(np.float32)).to(affine_dtype)
    beta = torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32)).to(affine_dtype)
    temb = torch.from_numpy(rs.randn(b, o).astype(np.float32)).to(torch.bfloat16)
    res = torch.from_numpy(rs.randn(b, h, w, o).astype(np.float32)).to(torch.bfloat16)
    return x, gamma, beta, wq, sw, bias, temb, res


@pytest.mark.parametrize("affine_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 2, 128, 32, 40), (2, 3, 64, 64, 24), (1, 7, 100, 96, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_tiled_ref_is_bit_exact(shape, affine_dtype):
    x, gamma, beta, wq, sw, bias, temb, res = _fused_inputs(np.random.RandomState(8), *shape,
                                                           affine_dtype)
    sx = static_scale(4.0)
    for kw in ({}, {"temb": temb}, {"residual": res}, {"temb": temb, "residual": res}):
        ref = tfr.fused_gn_silu_conv3x3_ref(x, gamma, beta, 16, 1e-5, wq, sw, sx, bias, **kw)
        for plan in _plans(shape, 5):
            out = tfr.fused_gn_silu_conv3x3_tiled_ref(x, gamma, beta, 16, 1e-5, wq, sw, sx,
                                                      bias, plan=plan, **kw)
            assert out.dtype == ref.dtype and torch.equal(out, ref)


@pytest.mark.parametrize("affine_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_activation_pass_ref_is_the_quantize_inside_the_plain_version(affine_dtype):
    x, gamma, beta, *_ = _fused_inputs(np.random.RandomState(9), 2, 6, 10, 64, 8, affine_dtype)
    x = (x.float() * 2.5 + 0.7).to(torch.bfloat16)  # moments away from 0 / 1
    sx = static_scale(4.0)
    # the steps of fused_gn_silu_conv3x3_ref up to its quantize
    aff = tfr.gn_affine(x, gamma, beta, 32, 1e-5)
    y = x.float() * aff[:, 0, None, None, :] + aff[:, 1, None, None, :]
    want = tci.quantize_int8(y * torch.sigmoid(y), sx)
    got = tfr.gn_silu_quantize_ref(x, tfr.group_norm_stats(x, 32, 1e-5), gamma, beta, sx)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert int((want != 0).sum()) > want.numel() // 2  # a quantize that is not all zeros
    # B3's pass: the plain quantize
    assert torch.equal(tci.quantize_int8(x, sx), tci.quantize_int8(x.float(), sx))


# ------------------------------------------------- against the JAX kernels
@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    mod = lambda name: importlib.import_module(f"paddlemix_tpu.ops.{name}")  # noqa: E731
    return types.SimpleNamespace(jnp=jnp, ci=mod("conv_int8"), fr=mod("fused_resnet"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PMIX_INT8_CONV", "pallas")
    monkeypatch.setenv("PMIX_INT8_CONV_PALLAS_MIN_HW", "0")


def _count_pallas_calls(monkeypatch, mod):
    calls = []
    pallas_call = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    return calls


def _torch_weight(w_io):
    """A JAX (3, 3, C, O) kernel as the port's (O, 3, 3, C) int8 weight and scales."""
    return tci.quantize_weight_per_cout(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(w_io, -1, 0))))


def test_conv_tiled_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch):
    rs = np.random.RandomState(10)
    x = rs.randn(1, 8, 8, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    sx = static_scale(np.abs(x).max())
    calls = _count_pallas_calls(monkeypatch, jx.ci)
    ref = np.asarray(jx.ci.int8_conv3x3_same(jx.jnp.asarray(x), jx.jnp.asarray(w), sx))
    assert len(calls) == 1  # the Pallas kernel ran, interpreted
    wq, sw = _torch_weight(w)
    for pair in (True, False):
        plan = gt.conv_plan(1, 8, 8, 128, 128, 5, tiles=gt.CONV_TILES[:1], pairings=(pair,))
        out = tci.int8_conv3x3_tiled_ref(torch.from_numpy(x), wq, sw, sx, plan=plan).numpy()
        # exact int32 sums on both sides, the same fp32 dequant product
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("case", [((1, 4, 16, 160), 320, "temb"),
                                  ((2, 8, 8, 128), 128, "residual")],
                         ids=["temb_160to320", "residual_128"])
def test_fused_tiled_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, case):
    (b, h, w, c), o, epi = case
    rs = np.random.RandomState(11)
    x = (rs.randn(b, h, w, c) * 0.8).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    w3 = (rs.randn(3, 3, c, o) * 0.05).astype(np.float32)
    bias = (0.1 * rs.randn(o)).astype(np.float32)
    extra = (rs.randn(b, o) if epi == "temb" else rs.randn(b, h, w, o)).astype(np.float32)
    sx = static_scale(4.0)
    calls = _count_pallas_calls(monkeypatch, jx.fr)
    ref = np.asarray(jx.fr.fused_gn_silu_conv3x3(
        *(jx.jnp.asarray(a) for a in (x, gamma, beta)), 32, 1e-5, jx.jnp.asarray(w3),
        jx.jnp.asarray(bias), sx, **{epi: jx.jnp.asarray(extra)}))
    assert len(calls) == 1
    wq, sw = _torch_weight(w3)
    t = torch.from_numpy
    out = tfr.fused_gn_silu_conv3x3_tiled_ref(t(x), t(gamma), t(beta), 32, 1e-5, wq, sw, sx,
                                              t(bias), **{epi: t(extra)}).numpy()
    # the GroupNorm moments are summed in another order; in fp32 that moves a
    # quantized value across a rounding boundary rarely, and one such step
    # moves an output by sx * sw[o] * |wq| <= sx * |w|max ~ 5e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))
