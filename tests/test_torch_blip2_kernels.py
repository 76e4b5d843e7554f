"""The BLIP-2 slice's kernels in the port, at the widths this slice gives
them: decode attention (B7, ops.decode_attention.decode_attention) at OPT's
head_dim 80, and LayerNorm's forward (B10, ops.norms.layer_norm) at
OPT-2.7B's 2,560-wide rows, whose backward stops at 2,048.

On the CPU: B7's plain version at D 80 against the JAX package's
`attention_xla` with its -1e9 bias over the cache (what JAX's OPT decode
runs), and the split walk against it; B10's plain version at 2,560 against
`layer_norm_xla`; the forward plans at 2,560 (the row form at two 16-byte
chunks a thread, 160 threads); the wrappers' acceptances and refusals. On a
CUDA card only: both kernels against their plain versions per element at
the path's shapes, the plans against the library's, and the refusals.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` tests also run where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_blip2_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import norms as tnorms
from paddlemix_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port

# fp32 on both sides: summation order, ~1e-7 of the values. bf16 outputs: at
# most one bf16 rounding step apart (2**-7 |value|) where the fp32 values
# straddle a rounding boundary.
FP32_TOL, BF16_ULP = 2e-6, 2.0 ** -7
# B10's rows on the BLIP-2 path (chip_smoke.BLIP2_LN_SHAPES), and B7's
# decode shapes at OPT's heads: (B, Hq, KVH, D, L, lengths)
LN_ROWS = [(257, 1408), (32, 768), (33, 2560), (1, 2560)]
DECODE_CASES = [(1, 32, 32, 80, 64, (40,)), (2, 32, 32, 80, 96, (90, 17)),
                (2, 8, 2, 80, 50, (50, 1))]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 attention=importlib.import_module("paddlemix_tpu.ops.attention"),
                                 norms=importlib.import_module("paddlemix_tpu.ops.norms"))


def _decode_inputs(seed, b, hq, kvh, d, L):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, 1, hq, d).astype(np.float32)
    k, v = (rs.randn(b, L, kvh, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,hq,kvh,d,L,lengths", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_attention_ref_at_head_dim_80_matches_jax_attention_xla(jx, b, hq, kvh, d, L,
                                                                       lengths, dtype):
    """JAX's OPT decode: attention_xla over the cache with a -1e9 bias past
    each length. B7's plain version masks those keys to NEG: both weigh them
    0, and round P to v's dtype before P V."""
    q, k, v = _decode_inputs(0, b, hq, kvh, d, L)
    bias = np.where(np.arange(L)[None, None, None, :] < np.asarray(lengths)[:, None, None, None],
                    0.0, -1e9).astype(np.float32)
    jdt, tdt = (jx.jnp.float32, torch.float32) if dtype == "fp32" else \
        (jx.jnp.bfloat16, torch.bfloat16)
    ref = jx.attention.attention_xla(*(jx.jnp.asarray(t, jdt) for t in (q, k, v)),
                                     bias=jx.jnp.asarray(bias))
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = tda.decode_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), lens)
    assert out.shape == (b, 1, hq, d) and out.dtype == tdt
    ref = np.asarray(ref.astype(jx.jnp.float32))
    got = out.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=FP32_TOL, rtol=1e-5)
    else:  # both round the same fp32 sums once; the sums' order differs
        assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-3 * np.abs(ref).max()).all()
    # the kernel's walk (key ranges merged) gives the same values
    split = tda.decode_attention_split_ref(*(torch.from_numpy(t) for t in (q, k, v)), lens)
    np.testing.assert_allclose(split.numpy(), ref if dtype == "fp32" else
                               tda.decode_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                                        lens).numpy(), atol=FP32_TOL, rtol=1e-5)


def test_decode_attention_takes_head_dim_80_on_the_bf16_cache_alone():
    q = torch.zeros(1, 1, 32, 80, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 32, 80, dtype=torch.bfloat16)
    lens = torch.tensor([40], dtype=torch.int32)
    assert tda._check_decode_args("decode_attention", q, k, k, lens, torch.bfloat16) == \
        (1, 64, 32, 32, 80)
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):  # B8 stays at 64 / 128
        tda._check_decode_args("decode_attention_int8", q, k.to(torch.int8), k.to(torch.int8),
                               lens, torch.int8)
    with pytest.raises(ValueError, match="head_dim"):
        tda._check_decode_args("decode_attention", q[..., :72], k[..., :72], k[..., :72], lens,
                               torch.bfloat16)
    # a BLIP-2 caption's cache: 65 keys, too few for a whole wave of ranges of
    # 16 keys: the most ranges up to one wave (4 of 17 keys)
    assert tda.key_splits(1, 32, 65) == (4, 17)
    # the paged kernel (B9) stays at 64 and 128
    assert not tpa.paged_decode_supported(32, 32, 80, 16)
    assert tpa.paged_decode_supported(32, 32, 128, 16)


@pytest.mark.parametrize("rows,h", LN_ROWS + [(1300, 2560)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_ref_at_the_blip2_widths_matches_jax_layer_norm_xla(jx, rows, h, dtype):
    rs = np.random.RandomState(rows + h)
    x = (rs.randn(rows, h) * rs.uniform(0.5, 3, (rows, 1)) + 2 * rs.randn(rows, 1))
    w, b = (1 + 0.2 * rs.randn(h)).astype(np.float32), (0.2 * rs.randn(h)).astype(np.float32)
    jdt, tdt = (jx.jnp.float32, torch.float32) if dtype == "fp32" else \
        (jx.jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jx.norms.layer_norm_xla(jx.jnp.asarray(x, jdt), jx.jnp.asarray(w),
                                             jx.jnp.asarray(b), 1e-6).astype(jx.jnp.float32))
    out = tnorms.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            torch.from_numpy(b), 1e-6)
    assert out.dtype == tdt and tnorms.layer_norm.launches == 0
    if dtype == "fp32":
        np.testing.assert_allclose(out.numpy(), ref, atol=FP32_TOL * np.abs(ref).max(), rtol=0)
    else:
        got = out.float().numpy()
        assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6 * np.abs(ref).max()).all()


def test_layer_norm_forward_plans_at_2560_and_the_backward_refusal():
    """2,560 bf16: the row form, two 16-byte chunks a thread, 160 threads;
    fp32 four; the one-element form 16 a thread; 2,561 too takes the row form
    (the forward's limit is 4,096), 4,097 no plan. The backward takes no plan
    above 2,048 and its wrapper refuses such rows with a message."""
    for rows in (1, 33, 1300):
        assert tnorms.layer_norm_plan(rows, 2560, 2).ints() == (tnorms.NORM_ROW, 8, 2, 160, 1,
                                                                rows)
        assert tnorms.layer_norm_plan(rows, 2560, 4).ints() == (tnorms.NORM_ROW, 4, 4, 160, 1,
                                                                rows)
        assert tnorms.layer_norm_plan(rows, 2560, 2, aligned=False).ints() == \
            (tnorms.NORM_ROW, 1, 16, 160, 1, rows)
        assert tnorms.layer_norm_plan(rows, 2561, 2).ints()[:2] == (tnorms.NORM_ROW, 1)
        assert tnorms.layer_norm_plan(rows, 4097, 2) is None
        assert tnorms.layer_norm_bwd_plan(rows, 2560, 2) is None
    x, w = torch.zeros(33, 2560, dtype=torch.bfloat16), torch.ones(2560)
    with pytest.raises(ValueError, match="at most 2048 wide.*training at that width is not"):
        tnorms._layer_norm_bwd_cuda(x, w, x, 1e-6)
    tnorms._ln_check("layer_norm", x, (w, w), tnorms._LN_FWD_MAX_WIDTH)


# -------------------------------------------------------------- on the card
def _within(out, ref, c):  # chip_smoke.py's per-element gate: 2**-7 |ref| + c |ref|max
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= BF16_ULP * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.gpu
def test_blip2_layer_norm_rows_match_plain_versions_on_gpu():
    """B10 at the path's rows (and fp32 and misaligned rows at 2,560) per
    element against the plain version, a control (the variance without the
    mean subtracted) outside the gate, each plan equal to the library's; the
    backward refuses 2,560 (no library plan either)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    for (rows, h), dtype, misaligned in [(s, bf16, False) for s in LN_ROWS] + \
            [((33, 2560), torch.float32, False), ((33, 2560), bf16, True)]:
        base = torch.randn((rows, h), generator=gen, device=dev)
        x = (base * (0.5 + 2.5 * torch.rand((rows, 1), generator=gen, device=dev))
             + 2 * torch.randn((rows, 1), generator=gen, device=dev)).to(dtype)
        if misaligned:
            x = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape).copy_(x)
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        before = tnorms.layer_norm.launches
        y = tnorms.layer_norm(x, w, b, 1e-6)
        torch.cuda.synchronize()
        assert tnorms.layer_norm.launches == before + 1
        ref = tnorms.layer_norm_ref(x.float(), w, b, 1e-6)
        assert _within(y, ref, 1e-6), (rows, h, dtype, misaligned)
        xf = x.float()
        no_mean = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)) * w + b
        assert not _within(no_mean, ref, 1e-6), (rows, h)  # the control fails the gate
        assert torch.equal(y, tnorms.layer_norm(x, w, b, 1e-6))
        plan = tnorms.layer_norm_plan_of(x, w, b)
        assert plan == tnorms.layer_norm_plan_library(rows, h, dtype, not misaligned)
        assert plan.vec == (1 if misaligned else 16 // x.element_size())
    for aligned in (True, False):
        assert tnorms.layer_norm_bwd_plan_library(33, 2560, bf16, aligned) is None
    x = torch.zeros((33, 2560), dtype=bf16, device=dev)
    with pytest.raises(ValueError, match="at most 2048 wide"):
        tnorms.layer_norm_backward(x, torch.ones(2560, device=dev), x, 1e-6)


@pytest.mark.gpu
def test_decode_attention_head_dim_80_matches_plain_version_on_gpu():
    """B7 at D 80 per element against the plain version, with every length
    one short a control that must fail; two launches bit-identical; the
    occupancy query answers for the bf16 cache at 80 and not for the int8
    one, whose wrapper refuses 80."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    for b, hq, kvh, d, L, lengths in DECODE_CASES + [(1, 32, 32, 80, 65, (64,))]:
        q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(bf16)
        cache = torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev).to(bf16)
        k, v = cache[0, :, :L], cache[1, :, :L]  # slices of a cache with its parking slot
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        before = tda.decode_attention.launches
        out = tda.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert tda.decode_attention.launches == before + 1
        ref = tda.decode_attention_ref(q.float(), k.float(), v.float(), lens)
        assert _within(out, ref, 4e-3), (b, hq, kvh, d, L, lengths)
        assert not _within(tda.decode_attention(q, k, v, lens - 1), ref, 4e-3)
        assert torch.equal(out, tda.decode_attention(q, k, v, lens))
        assert tda.kernel_blocks_per_sm(80, hq // kvh, False) >= tda.WAVE_BLOCKS_PER_SM
    assert tda.kernel_blocks_per_sm(80, 1, True) < 0
    k8 = torch.zeros((1, 64, 32, 80), dtype=torch.int8, device=dev)
    s8 = torch.ones((1, 64, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention_int8(torch.zeros((1, 1, 32, 80), dtype=bf16, device=dev), k8, k8,
                                  s8, s8, torch.tensor([4], dtype=torch.int32, device=dev))
