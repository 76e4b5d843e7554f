"""The tile plans of the port's wgmma GEMM core (paddlemix_tpu_torch.ops.
gemm_tiles), which the int8 a8w8 GEMM (B2) and the weight-only int8 GEMM's
tiled path (B6) run on: the walk covers every output tile once at the smoke's
shapes and at ragged ones, and the tiled plain versions, which walk the
kernels' tiles, K stages and zero-filled edges, agree with the plain
versions (B2 bit-exact, B6 within the smoke's per-element gate) and with
the JAX package's Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from chip_smoke import GEMM_RAGGED, GEMM_SHAPES, WINT8_RAGGED, WINT8_SHAPES, WINT8_ULP, WINT8_SUM
from paddlemix_tpu_torch.ops import conv_int8 as tci
from paddlemix_tpu_torch.ops import gemm_tiles as gt
from paddlemix_tpu_torch.ops import quant as tquant
from paddlemix_tpu_torch.ops.quant import static_scale

pytestmark = pytest.mark.torch_port

# (M, K, N): M no multiple of the tile, N = 8 mod 16, K no multiple of the
# 64-deep stage; a shape below one tile; one whose weight blocks pair up unevenly
RAGGED = [GEMM_RAGGED, WINT8_RAGGED, (100, 48, 24), (300, 336, 264), (608, 4096, 11008 + 128)]


def _kernel_cases():
    a8w8 = [("a8w8", s) for s in GEMM_SHAPES + RAGGED]
    wint8 = [("wint8", s) for s in WINT8_SHAPES + RAGGED if s[0] > 1]
    return a8w8 + wint8


@pytest.mark.parametrize("clusters", [gt.H100_CLUSTERS, 5], ids=["h100", "five_clusters"])
@pytest.mark.parametrize("kind, mkn", _kernel_cases(),
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in _kernel_cases()])
def test_walk_covers_every_tile_once(kind, mkn, clusters):
    m, k, n = mkn
    plan_fn = gt.a8w8_plan if kind == "a8w8" else gt.wint8_plan
    tiles = gt.A8W8_TILES if kind == "a8w8" else gt.WINT8_TILES
    for tile in tiles:  # the picked width and every other compiled one
        plan = plan_fn(m, n, k, clusters, tiles=(tile,))
        assert plan.grid % gt.CLUSTER == 0 and plan.grid <= gt.CLUSTER * clusters
        walked = [t for block in plan.walk() for t in block]
        real = [t for t in walked if plan.in_range(*t)]
        assert sorted(real) == [(o, i) for o in range(plan.outer_tiles)
                                for i in range(plan.inner_tiles)]
        # the only tiles past the edge: a pair's second one where the paired count is odd
        phantoms = [t for t in walked if not plan.in_range(*t)]
        paired = plan.inner_tiles if plan.pair_inner else plan.outer_tiles
        assert len(phantoms) == (plan.units // plan.unit_inner if plan.pair_inner
                                 else plan.unit_inner) * (paired % 2)
        # the two blocks of a cluster run tiles that read the same rows of x
        blocks = plan.walk()
        for b in range(0, plan.grid, gt.CLUSTER):
            for t0, t1 in zip(blocks[b], blocks[b + 1]):
                assert (t0[0] == t1[0]) if plan.pair_inner else (t0[1] == t1[1])
        covered = np.zeros((m, n), dtype=np.int32)
        for t in real:
            rows, cols = plan.region(*t)
            covered[rows, cols] += 1
        assert (covered == 1).all()


def test_plans_at_the_smoke_shapes():
    """The tile widths the cost model picks on an H100 (66 clusters of 2)."""
    assert [gt.a8w8_plan(m, n, k).tile for m, k, n in GEMM_SHAPES] == [256, 256, 256, 128,
                                                                        256]
    assert [gt.wint8_plan(m, n, k).tile for m, k, n in WINT8_SHAPES if m > 1] == [208, 152]
    plan = gt.wint8_plan(608, 11008, 4096)
    assert (plan.outer_tiles, plan.inner_tiles, plan.grid) == (86, 3, 132)


def _a8w8_inputs(rs, m, k, n):
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    wq, sw = tci.quantize_weight_per_cout(torch.from_numpy((rs.randn(n, k) * k ** -0.5)
                                                           .astype(np.float32)))
    bias = torch.from_numpy((0.1 * rs.randn(n)).astype(np.float32))
    return x, wq, sw, static_scale(x.float().abs().max().item()), bias


@pytest.mark.parametrize("tile", gt.A8W8_TILES)
@pytest.mark.parametrize("mkn", [(300, 336, 264), (100, 48, 24), (130, 1296, 264)],
                         ids=["ragged", "below_one_tile", "pair_past_the_edge"])
def test_a8w8_tiled_ref_is_bit_exact(mkn, tile):
    m, k, n = mkn
    x, wq, sw, sx, bias = _a8w8_inputs(np.random.RandomState(3), m, k, n)
    plan = gt.a8w8_plan(m, n, k, tiles=(tile,))
    for b in (bias, None):
        ref = tci.int8_a8w8_matmul_ref(x, wq, sw, sx, b)
        out = tci.int8_a8w8_matmul_tiled_ref(x, wq, sw, sx, b, plan=plan)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, ref)  # int32 sums in any order, the same fp32 epilogue


def _wint8_inputs(rs, m, k, n):
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    wq, scale = tquant.quantize_weights_int8(torch.from_numpy(rs.randn(n, k).astype(np.float32)))
    return x, wq, scale


def _within_wint8_gate(out, ref):
    """The smoke's B6 gate: |out - ref| <= 2**-7 |ref| + 1e-5 |ref|max."""
    out, ref = out.float(), ref.float()
    limit = WINT8_ULP * ref.abs() + WINT8_SUM * ref.abs().max()
    return bool(((out - ref).abs() <= limit).all())


@pytest.mark.parametrize("tile", gt.WINT8_TILES)
@pytest.mark.parametrize("mkn", [(77, 1040, 264), (3, 1008, 200), (208, 64, 392)],
                         ids=["ragged", "three_rows", "odd_weight_blocks"])
def test_wint8_tiled_ref_within_gate(mkn, tile):
    m, k, n = mkn
    x, wq, scale = _wint8_inputs(np.random.RandomState(4), m, k, n)
    ref = tquant.wint8_matmul_ref(x, wq, scale)
    out = tquant.wint8_matmul_tiled_ref(x, wq, scale, plan=gt.wint8_plan(m, n, k, tiles=(tile,)))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert _within_wint8_gate(out, ref)


# ------------------------------------------------- against the JAX kernels
@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    mod = lambda name: importlib.import_module(f"paddlemix_tpu.ops.{name}")  # noqa: E731
    return types.SimpleNamespace(jnp=jnp, ci=mod("conv_int8"), quant=mod("quant"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PMIX_INT8_MM", "pallas")


def _count_pallas_calls(monkeypatch, mod):
    calls = []
    pallas_call = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    return calls


def test_a8w8_tiled_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch):
    m, k, n = 152, 384, 384  # JAX's kernel takes K, N % 128 == 0; ragged rows, 3 column tiles
    rs = np.random.RandomState(5)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(k, n) * k ** -0.5).astype(np.float32)
    sx = static_scale(np.abs(x).max())
    calls = _count_pallas_calls(monkeypatch, jx.ci)
    ref = np.asarray(jx.ci.int8_a8w8_matmul(jx.jnp.asarray(x), jx.jnp.asarray(w), sx))
    assert len(calls) == 1  # the Pallas kernel ran, interpreted
    wq, sw = tci.quantize_weight_per_cout(torch.from_numpy(np.ascontiguousarray(w.T)))
    out = tci.int8_a8w8_matmul_tiled_ref(torch.from_numpy(x), wq, sw, sx).numpy()
    # exact int32 sums on both sides, the same fp32 dequant product
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_wint8_tiled_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch):
    m, k, n = 72, 384, 384  # JAX's kernel takes K, N % 128 == 0; two token tiles, 3 weight blocks
    rs = np.random.RandomState(6)
    x = rs.randn(m, k).astype(np.float32)
    jq, js = jx.quant.quantize_weights_int8(jx.jnp.asarray(rs.randn(k, n).astype(np.float32)))
    calls = _count_pallas_calls(monkeypatch, jx.quant)
    ref = np.asarray(jx.quant.wint8_matmul(jx.jnp.asarray(x), jq, js))
    assert len(calls) == 1
    wq = torch.from_numpy(np.ascontiguousarray(np.asarray(jq).T))
    out = tquant.wint8_matmul_tiled_ref(torch.from_numpy(x), wq,
                                        torch.tensor(np.asarray(js))).numpy()
    # both round x to bf16 and sum exact products in fp32: summation order only
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
