"""The LLaVA slice's kernels in the port: weight-only int8 GEMM (B6,
ops.quant.wint8_matmul), decode attention (B7, ops.decode_attention) and
RMSNorm (B11, ops.norms.rms_norm). Their plain versions are held against the
JAX package's Pallas kernels, run in interpret mode (a count of `pallas_call`
shows that the kernel really ran), and against its XLA references where the
JAX package routes there; the wint8 quantizer is held bit-exact; rope against
the JAX rope. On a CUDA card only, each kernel against its plain version.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_llava_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import norms as tnorms
from paddlemix_tpu_torch.ops import quant as tquant
from paddlemix_tpu_torch.ops import rope as trope
from paddlemix_tpu_torch.ops.gemm_tiles import WINT8_TILES

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    # importlib: the package re-exports a function under the module's name
    mod = lambda name: importlib.import_module(f"paddlemix_tpu.ops.{name}")  # noqa: E731
    return types.SimpleNamespace(jnp=jnp, da=mod("decode_attention"), norms=mod("norms"),
                                 quant=mod("quant"), rope=mod("rope"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _count_pallas_calls(monkeypatch, module):
    """Count the `pallas_call`s `module` makes from here on."""
    calls = []
    pallas_call = module.pl.pallas_call
    monkeypatch.setattr(module.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    return calls


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


# ------------------------------------------------------ B6: wint8 GEMM
def test_wint8_quantizer_is_bit_exact(jx):
    rs = np.random.RandomState(0)
    w = (rs.randn(256, 384) * 0.05).astype(np.float32)  # flax (K, N)
    w[:, 7] = 0.0  # an all-zero output column takes scale 1.0
    w[3, 9] = 2.5 * np.abs(w[:, 9]).max()  # a column whose absmax is one outlier
    jq, js = jx.quant.quantize_weights_int8(jx.jnp.asarray(w))
    wq, scale = tquant.quantize_weights_int8(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert scale[7].item() == 1.0 and (wq[7] == 0).all()


def test_wint8_quantizer_rounds_half_to_even():
    # absmax 127 -> scale 1.0: w / scale is w itself
    w = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]])
    wq, scale = tquant.quantize_weights_int8(w)
    assert scale.item() == 1.0
    assert wq.tolist() == [[0, 2, 2, 0, -2, -2, 126, 127]]


@pytest.mark.parametrize("mkn", [(64, 256, 384), (8, 384, 256)], ids=["m64", "m8"])
def test_wint8_matmul_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, mkn):
    m, k, n = mkn
    rs = np.random.RandomState(1)
    x = rs.randn(m, k).astype(np.float32)
    jq, js = jx.quant.quantize_weights_int8(jx.jnp.asarray(rs.randn(k, n).astype(np.float32)))
    calls = _count_pallas_calls(monkeypatch, jx.quant)
    ref = jx.quant.wint8_matmul(jx.jnp.asarray(x), jq, js)
    assert len(calls) == 1  # the Pallas kernel ran, interpreted
    wq = torch.from_numpy(np.ascontiguousarray(np.asarray(jq).T))
    out = tquant.wint8_matmul(torch.from_numpy(x), wq, torch.tensor(np.asarray(js)))
    assert out.dtype == torch.float32
    # both round x to bf16 and sum exact products in fp32: summation order only
    _assert_close(ref, out, tol=1e-5)
    assert tquant.wint8_matmul.launches == 0


def test_wint8_matmul_decode_row_matches_jax_xla(jx, pallas_interpret, monkeypatch):
    """M = 1 is not a multiple of 8, so the JAX function takes its XLA dot
    (its model pads decode rows to 8; the port does not)."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 1, 384).astype(np.float32)
    jq, js = jx.quant.quantize_weights_int8(jx.jnp.asarray(rs.randn(384, 256).astype(np.float32)))
    calls = _count_pallas_calls(monkeypatch, jx.quant)
    ref = jx.quant.wint8_matmul(jx.jnp.asarray(x), jq, js)
    assert len(calls) == 0
    out = tquant.wint8_matmul_ref(torch.from_numpy(x),
                                  torch.from_numpy(np.ascontiguousarray(np.asarray(jq).T)),
                                  torch.tensor(np.asarray(js)))
    assert out.shape == (1, 1, 256)
    _assert_close(ref, out, tol=1e-5)


# ------------------------------------------------ B7: decode attention
def _decode_inputs(rs, b, L, kvh, g, d, lengths, dtype=np.float32):
    q = rs.randn(b, 1, kvh * g, d).astype(dtype)
    k = rs.randn(b, L, kvh, d).astype(dtype)
    v = rs.randn(b, L, kvh, d).astype(dtype)
    for i, n in enumerate(lengths):  # garbage past each length, large enough to show
        k[i, n:] = 30.0 * rs.randn(L - n, kvh, d)
        v[i, n:] = 1e3
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [1, 2], ids=["mha", "gqa2"])
def test_decode_attention_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, g):
    rs = np.random.RandomState(3)
    # lengths 200 and 77 over 64-key blocks: a partial last block, and
    # blocks wholly past the length that the kernel skips
    q, k, v, lengths = _decode_inputs(rs, 2, 256, 2, g, 64, [200, 77])
    calls = _count_pallas_calls(monkeypatch, jx.da)
    ref = jx.da.decode_attention(*(jx.jnp.asarray(a) for a in (q, k, v, lengths)), block_k=64)
    assert len(calls) == 1
    t = torch.from_numpy
    out = tda.decode_attention(t(q), t(k), t(v), t(lengths))
    _assert_close(ref, out, tol=1e-5)  # fp32 throughout: summation order only
    assert np.abs(np.asarray(ref)).max() < 10  # the garbage (v = 1e3) was masked
    assert tda.decode_attention.launches == 0


def test_decode_attention_ref_matches_jax_pallas_bf16(jx, pallas_interpret):
    rs = np.random.RandomState(4)
    q, k, v, lengths = _decode_inputs(rs, 2, 256, 2, 2, 64, [256, 130])
    jb = [jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in (q, k, v)]
    ref = jx.da.decode_attention(*jb, jx.jnp.asarray(lengths), block_k=64).astype(np.float32)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    out = tda.decode_attention(*tb, torch.from_numpy(lengths))
    assert out.dtype == torch.bfloat16
    # the Pallas kernel rounds the unnormalized P to bf16, the plain version
    # the normalized one, and both round the output to bf16: 2**-7 each
    _assert_close(np.asarray(ref), out, tol=1e-2)


def test_decode_attention_ref_is_jax_xla_reference(jx):
    rs = np.random.RandomState(5)
    q, k, v, lengths = _decode_inputs(rs, 2, 96, 1, 2, 64, [96, 5])
    ref = jx.da.decode_attention_xla(*(jx.jnp.asarray(a) for a in (q, k, v, lengths)))
    out = tda.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lengths)))
    _assert_close(ref, out, tol=1e-6)


# ----------------------------------------------------------- B11: RMSNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, dtype):
    rs = np.random.RandomState(6)
    x = (rs.randn(128, 256) * 3 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    ref = jx.norms.rms_norm(jx.jnp.asarray(x).astype(dtype), jx.jnp.asarray(w), 1e-5)
    assert len(calls) == 1
    out = tnorms.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
                          1e-5)
    assert out.dtype == getattr(torch, dtype)
    # fp32: summation order; bf16: the same fp32 math, then one bf16 rounding
    # of values below 5 (an ulp of 2**-6 at most)
    _assert_close(np.asarray(ref.astype("float32")), out, tol=1e-5 if dtype == "float32" else 2e-2)
    assert tnorms.rms_norm.launches == 0


def test_rms_norm_single_row_matches_jax_xla(jx):
    rs = np.random.RandomState(7)
    x = rs.randn(1, 1, 256).astype(np.float32)
    w = rs.rand(256).astype(np.float32)
    ref = jx.norms.rms_norm_xla(jx.jnp.asarray(x), jx.jnp.asarray(w), 1e-5)
    _assert_close(ref, tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5), 1e-6)


# --------------------------------------------------------------- rope
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(jx, dtype):
    rs = np.random.RandomState(8)
    pos = np.array([[0, 1, 2, 700], [5, 6, -1, -1]], np.int32)
    q = rs.randn(2, 4, 2, 64).astype(np.float32)
    k = rs.randn(2, 4, 1, 64).astype(np.float32)
    jcos, jsin = jx.rope.rope_cos_sin(jx.jnp.asarray(pos), 64, 10000.0)
    cos, sin = trope.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0)
    _assert_close(jcos, cos, 1e-6)
    _assert_close(jsin, sin, 1e-6)
    jq, jk = jx.rope.apply_rope(jx.jnp.asarray(q).astype(dtype), jx.jnp.asarray(k).astype(dtype),
                                jcos, jsin)
    tq, tk = trope.apply_rope(torch.from_numpy(q).to(getattr(torch, dtype)),
                              torch.from_numpy(k).to(getattr(torch, dtype)), cos, sin)
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16: cos/sin cast, then bf16 products
    _assert_close(np.asarray(jq.astype("float32")), tq, tol)
    _assert_close(np.asarray(jk.astype("float32")), tk, tol)


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError):
        tquant.wint8_matmul(torch.empty(1, 32, device="meta"),
                            torch.empty(8, 32, dtype=torch.int8, device="meta"),
                            torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        tda.decode_attention(torch.empty(1, 1, 2, 64, device="meta"),
                             torch.empty(1, 8, 2, 64, device="meta"),
                             torch.empty(1, 8, 2, 64, device="meta"),
                             torch.empty(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        tnorms.rms_norm(torch.empty(2, 64, device="meta"), torch.empty(64, device="meta"))


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_llava_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def counted(fn, *args):
        before = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        return out

    # B6: the GEMV path (M = 1) and the tiled path, ragged M, N not a
    # multiple of the 128-wide tile, K not a multiple of the 64-deep stage;
    # (77, 4112, 4104) also at every compiled token tile
    for m, k, n in [(1, 4096, 4096), (3, 1008, 200), (5, 4096, 11008), (130, 11008, 264),
                    (77, 4112, 4104)]:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wq, scale = tquant.quantize_weights_int8(torch.randn((n, k), generator=gen, device=dev))
        ref = tquant.wint8_matmul_ref(x, wq, scale).float()
        # fp32 sums of exact products in another order, then one bf16 rounding
        limit = 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        runs = [lambda: counted(tquant.wint8_matmul, x, wq, scale)]
        if m == 77:
            runs += [lambda t=t: tquant._wint8_cuda(x, wq, scale, tiles=(t,))
                     for t in WINT8_TILES]
        for run in runs:
            out = run()
            torch.cuda.synchronize()
            assert ((out.float() - ref).abs() <= limit).all(), (m, k, n)

    # B7: head dims 64 and 128, every group size, a strided cache slice, a
    # length past L (clamped) and a length of 0 (zeros, like the TPU kernel)
    for d, g, lengths, L in [(128, 1, [609], 736), (64, 2, [300, 1], 301),
                             (128, 4, [4000, 1500], 4096), (64, 8, [700, 0], 700),
                             (128, 2, [90, 40], 64)]:
        b, kvh = len(lengths), 4
        q = torch.randn((b, 1, kvh * g, d), generator=gen, device=dev).to(bf16)
        cache = torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev).to(bf16)
        kc, vc = cache[0, :, :L], cache[1, :, :L]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = counted(tda.decode_attention, q, kc, vc, lens).float()
        ref = tda.decode_attention_ref(q.float(), kc.float(), vc.float(), lens)
        valid = lens > 0
        # bf16 P and output against fp32, per element: the output's rounding
        # plus P's, |out - ref| <= 2**-7 |ref| + 4e-3 |ref|max
        o, r = out[valid], ref[valid]
        assert ((o - r).abs() <= 2.0 ** -7 * r.abs() + 4e-3 * r.abs().max()).all(), \
            (d, g, lengths)
        assert (out[~valid] == 0).all()
    # B11: the decode row, the prefill rows, the SFT forward's rows, a width
    # that is not a power of 2, a width of no whole 16 bytes and x one element
    # past a 16-byte boundary (the one-element form)
    for rows, h, misaligned in [(1, 4096, False), (608, 4096, False), (4096, 4096, False),
                                (7, 320, False), (37, 4100, False), (33, 4096, True)]:
        x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(bf16)
        if misaligned:
            x = torch.empty(x.numel() + 1, dtype=bf16, device=dev)[1:].view(x.shape).copy_(x)
        w = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
        out = counted(tnorms.rms_norm, x, w, 1e-5).float()
        ref = tnorms.rms_norm_ref(x.float(), w, 1e-5)
        assert (out - ref).abs().max().item() <= 3e-2  # bf16 output rounding (values < 8)
        # and per element: one bf16 rounding apart, plus fp32 summation order
        assert ((out - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6 * ref.abs().max()).all()
