"""The port's static-a8w8 kernels (paddlemix_tpu_torch.ops.conv_int8,
ops.fused_resnet): plain versions against the JAX package's Pallas kernels
(interpret mode), the quantizer's rounding, the int8 overflow trap, the
routing of every SDXL a8w8 op, and, on a CUDA card only, each kernel against
its plain version.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_a8w8_kernels.py
"""

import types
from collections import Counter

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import conv_int8 as tci
from paddlemix_tpu_torch.ops import fused_resnet as tfr
from paddlemix_tpu_torch.ops.quant import QuantConv2d, QuantLinear, conv_route, static_scale

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from paddlemix_tpu.ops import conv_int8, fused_resnet

    return types.SimpleNamespace(jnp=jnp, ci=conv_int8, fr=fused_resnet)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PMIX_INT8_MM", "pallas")
    monkeypatch.setenv("PMIX_INT8_CONV", "pallas")
    monkeypatch.setenv("PMIX_INT8_CONV_PALLAS_MIN_HW", "0")


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _torch_weight(w_io):
    """A JAX (..., I, O) kernel as the port's int8 weight and scales."""
    w = torch.from_numpy(np.ascontiguousarray(np.moveaxis(w_io, -1, 0)))  # (O, ..., I)
    return tci.quantize_weight_per_cout(w)


# ------------------------------------------------------------------ quantizer
def test_quantizer_rounds_half_to_even_and_clips(jx):
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 300.0, -300.0, 0.49],
                 np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126, 127, 127, -127, 0], np.int8)
    out = tci.quantize_int8(torch.from_numpy(x), 1.0)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jx.ci._quantize_int8(jx.jnp.asarray(x), 1.0)), want)


def test_weight_quantization_matches_jax(jx):
    w = (np.random.RandomState(0).randn(3, 3, 32, 48) * 0.05).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes the 1e-8 floor
    jwq, jsw = jx.ci.quantize_weight_per_cout(jx.jnp.asarray(w))
    wq, sw = _torch_weight(w)
    np.testing.assert_array_equal(wq.numpy(), np.moveaxis(np.asarray(jwq), -1, 0))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))  # same fp32 ops, bit-exact


def test_int8_products_that_overflow_int8_stay_exact():
    xq = torch.full((4, 64), 100, dtype=torch.int8)
    wq = torch.full((8, 64), 100, dtype=torch.int8)
    exact = 100 * 100 * 64  # 640,000
    assert (xq @ wq.t())[0, 0].item() != exact  # PyTorch's int8 matmul wraps silently
    sw = torch.ones(8)
    out = tci.int8_a8w8_matmul(xq.float(), wq, sw, 1.0)
    assert out.dtype == torch.float32
    assert (out == exact).all()
    conv = tci.int8_conv3x3_same(torch.full((1, 3, 3, 64), 100.0), wq.view(8, 1, 1, 64)
                                 .expand(8, 3, 3, 64).contiguous(), sw, 1.0)
    assert conv[0, 1, 1, 0].item() == 9 * exact  # the centre pixel sees all nine taps


# ------------------------------------------------------------ B2: int8 GEMM
@pytest.mark.parametrize("mkn, pallas", [((64, 256, 256), True), ((152, 256, 128), True),
                                         ((154, 256, 128), False)],
                         ids=["aligned", "ragged_m152", "ragged_m154"])
def test_int8_matmul_ref_matches_jax_interpret(jx, pallas_interpret, monkeypatch, mkn, pallas):
    m, k, n = mkn
    rs = np.random.RandomState(1)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(k, n) * k ** -0.5).astype(np.float32)
    sx = static_scale(np.abs(x).max())
    pallas_calls = []
    pallas_call = jx.ci.pl.pallas_call
    monkeypatch.setattr(jx.ci.pl, "pallas_call",
                        lambda *a, **kw: pallas_calls.append(1) or pallas_call(*a, **kw))
    ref = jx.ci.int8_a8w8_matmul(jx.jnp.asarray(x), jx.jnp.asarray(w), sx)
    # M = 152 is one 152-row Pallas block (ragged against the port's 128-row
    # tile); M = 154 is not a multiple of 8, so JAX takes its int8 XLA dot:
    # the same function, outside the Pallas kernel
    assert len(pallas_calls) == int(pallas)
    wq, sw = _torch_weight(w)
    out = tci.int8_a8w8_matmul(torch.from_numpy(x), wq, sw, sx)
    # the int32 sums are exact on both sides and the fp32 dequant is the same
    # product: only the last bit of the fp32 multiply may differ
    _assert_close(ref, out, tol=1e-6)
    assert tci.int8_a8w8_matmul.launches == 0


# -------------------------------------------------------- B3: int8 3x3 conv
def test_int8_conv3x3_ref_matches_jax_interpret(jx, pallas_interpret):
    rs = np.random.RandomState(2)
    x = rs.randn(1, 8, 8, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    sx = static_scale(np.abs(x).max())
    ref = jx.ci.int8_conv3x3_same(jx.jnp.asarray(x), jx.jnp.asarray(w), sx)
    wq, sw = _torch_weight(w)  # (O, 3, 3, C): the kernels' layout
    out = tci.int8_conv3x3_same(torch.from_numpy(x), wq, sw, sx)
    _assert_close(ref, out, tol=1e-6)  # exact int32 sums, as for the GEMM
    assert tci.int8_conv3x3_same.launches == 0


# ---------------------------------------- B5: GroupNorm+SiLU+int8 conv fused
@pytest.mark.parametrize("case", [((1, 4, 16, 160), 320, "temb"),
                                  ((2, 8, 8, 128), 128, "residual")],
                         ids=["temb_160to320", "residual_128"])
def test_fused_ref_matches_jax_interpret(jx, pallas_interpret, case):
    (b, h, w, c), o, epi = case
    rs = np.random.RandomState(3)
    x = (rs.randn(b, h, w, c) * 0.8).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    beta = (0.1 * rs.randn(c)).astype(np.float32)
    w3 = (rs.randn(3, 3, c, o) * 0.05).astype(np.float32)
    bias = (0.1 * rs.randn(o)).astype(np.float32)
    extra = (rs.randn(b, o) if epi == "temb" else rs.randn(b, h, w, o)).astype(np.float32)
    sx = static_scale(4.0)
    assert jx.fr.fused_supported(x.shape, w3.shape)  # the Pallas kernel runs, interpreted
    ref = jx.fr.fused_gn_silu_conv3x3(*(jx.jnp.asarray(a) for a in (x, gamma, beta)), 32, 1e-5,
                                      jx.jnp.asarray(w3), jx.jnp.asarray(bias), sx,
                                      **{epi: jx.jnp.asarray(extra)})
    wq, sw = _torch_weight(w3)
    t = torch.from_numpy
    out = tfr.fused_gn_silu_conv3x3(t(x), t(gamma), t(beta), 32, 1e-5, wq, sw, sx, t(bias),
                                    **{epi: t(extra)})
    # the GroupNorm moments are summed in another order; in fp32 that moves a
    # quantized value across a rounding boundary rarely, and one such step
    # moves an output by sx * sw[o] * |wq| <= sx * |w|max ~ 5e-3
    _assert_close(ref, out, tol=1e-4)
    assert tfr.fused_gn_silu_conv3x3.launches == 0


def test_gn_affine_matches_jax(jx):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 6, 5, 64).astype(np.float32) * 3 + 1
    gamma, beta = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    ref = jx.fr.gn_affine(jx.jnp.asarray(x), jx.jnp.asarray(gamma), jx.jnp.asarray(beta), 32,
                          1e-5)
    out = tfr.gn_affine(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                        32, 1e-5)
    _assert_close(ref, out, tol=1e-5)  # fp32 sums in another order


# ------------------------------------------------------------------ routing
def _sdxl_models():
    from paddlemix_tpu_torch.diffusers.models import (
        AutoencoderKL,
        AutoencoderKLConfig,
        UNet2DConditionConfig,
        UNet2DConditionModel,
    )
    from paddlemix_tpu_torch.diffusers.sdxl import SDXL_UNET, SDXL_VAE

    with torch.device("meta"):
        return (UNet2DConditionModel(UNet2DConditionConfig(**SDXL_UNET, quant="a8w8_static")),
                AutoencoderKL(AutoencoderKLConfig(**SDXL_VAE, quant="a8w8_static")))


def _op_kind(name, module):
    """The op of the routing table a quantized module is, from its name."""
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(module, QuantLinear):
        return "linear"
    if leaf == "conv_shortcut":
        return "shortcut_1x1"
    if leaf in ("conv1", "conv2"):
        return "resnet_3x3"
    if ".upsamplers." in name:
        return "upsample_3x3"
    if ".downsamplers." in name:
        return "downsample_s2"
    return "proj_1x1"


def test_routing_of_every_sdxl_a8w8_op():
    """Each quantized op of the full-width SDXL UNet / VAE decoder goes where
    the routing table of PERF.md says, and every shape it will see is one its
    kernel takes (a CUDA tensor the kernel's checks reject would raise)."""
    from paddlemix_tpu_torch.diffusers.sdxl import a8w8_routes

    table = {"linear": "int8_a8w8_matmul", "shortcut_1x1": "int8_a8w8_matmul",
             "resnet_3x3": "fused_gn_silu_conv3x3", "upsample_3x3": "int8_conv3x3_same",
             "downsample_s2": "int8_conv2d_plain"}
    want = {"unet": {"linear": 722, "shortcut_1x1": 11, "resnet_3x3": 34, "upsample_3x3": 2,
                     "downsample_s2": 2},
            "vae": {"shortcut_1x1": 2, "resnet_3x3": 28, "upsample_3x3": 3}}
    for label, model in zip(("unet", "vae"), _sdxl_models()):
        kinds = Counter()
        for name, m in model.named_modules():
            if not isinstance(m, (QuantLinear, QuantConv2d)):
                continue
            kind = _op_kind(name, m)
            kinds[kind] += 1
            if isinstance(m, QuantConv2d) and kind != "resnet_3x3":
                assert m.route == table[kind], name
            if isinstance(m, QuantLinear):
                assert tci.gemm_kernel_takes(2 * 4096, m.in_features, m.out_features), name
            elif m.route != "int8_conv2d_plain":
                assert tci.conv3x3_kernel_takes(1, 1024, 1024, m.in_channels,
                                                m.out_channels), name
        assert dict(kinds) == want[label]
        routes = a8w8_routes(model)
        got = Counter()
        for kind, n in kinds.items():
            got[table[kind]] += n
        assert {k: v for k, v in routes.items() if k != "group_norm_stats"} == dict(got)
    # attn2's k/v run on the 77-token text at CFG batch 2: M = 154, no tile multiple
    assert tci.gemm_kernel_takes(154, 2048, 1280)
    assert conv_route((1, 1), (1, 1), (0, 0)) == "int8_a8w8_matmul"
    assert conv_route((3, 3), (1, 1), (1, 1)) == "int8_conv3x3_same"
    assert conv_route((3, 3), (2, 2), (1, 1)) == "int8_conv2d_plain"


def test_wrappers_reject_other_devices():
    x = torch.empty(4, 32, device="meta")
    wq = torch.empty(8, 32, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tci.int8_a8w8_matmul(x, wq, torch.empty(8, device="meta"), 0.1)
    with pytest.raises(ValueError):
        tci.int8_conv3x3_same(torch.empty(1, 4, 4, 32, device="meta"),
                              torch.empty(8, 3, 3, 32, dtype=torch.int8, device="meta"),
                              torch.empty(8, device="meta"), 0.1)


# -------------------------------------------------------------- on the card
def bf16_ulps(out, ref):
    """max |out - ref| in units of one bf16 ulp of ref (<= 2**-7 * |ref|)."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (2.0 ** -7 * ref.abs() + 2.0 ** -126)).max().item()


@pytest.mark.gpu
def test_int8_kernels_match_plain_versions_on_gpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def unquantized(x, sx):  # the plain versions without their activation quantize
        return x.float() * (1.0 / sx)

    def check(kernel, plain, counter):
        before = counter.launches
        out = kernel()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        # the int32 sums are exact and every fp32 step rounds as in the plain
        # version (bit-exact when measured): at most one bf16 rounding apart
        assert bf16_ulps(out, plain()) <= 1.0
        with monkeypatch.context() as mp:  # the control: this gate tells a missing quantize
            mp.setattr(tci, "quantize_int8", unquantized)
            mp.setattr(tfr, "quantize_int8", unquantized)
            assert bf16_ulps(plain(), out) > 1.0

    # (100, 48, 24) has a ragged M and K below one tile
    for m, k, n in [(154, 2048, 1280), (300, 640, 320), (100, 48, 24)]:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wq, sw = tci.quantize_weight_per_cout(torch.randn((n, k), generator=gen, device=dev))
        bias = torch.randn(n, generator=gen, device=dev)
        sx = static_scale(x.float().abs().max().item())
        check(lambda: tci.int8_a8w8_matmul(x, wq, sw, sx, bias),
              lambda: tci.int8_a8w8_matmul_ref(x, wq, sw, sx, bias), tci.int8_a8w8_matmul)
    for b, h, w, c, o in [(2, 16, 16, 320, 640), (1, 9, 13, 16, 8)]:
        x = torch.randn((b, h, w, c), generator=gen, device=dev).to(bf16)
        wq, sw = tci.quantize_weight_per_cout(torch.randn((o, c, 3, 3), generator=gen,
                                                          device=dev))
        wq = tci.conv3x3_weight_layout(wq)
        bias = torch.randn(o, generator=gen, device=dev)
        sx = static_scale(x.float().abs().max().item())
        check(lambda: tci.int8_conv3x3_same(x, wq, sw, sx, bias),
              lambda: tci.int8_conv3x3_same_ref(x, wq, sw, sx, bias), tci.int8_conv3x3_same)
        gamma = torch.rand(c, generator=gen, device=dev) + 0.5
        beta = torch.randn(c, generator=gen, device=dev)
        groups = 16 if c == 16 else 32
        temb = torch.randn((b, o), generator=gen, device=dev).to(bf16)
        res = torch.randn((b, h, w, o), generator=gen, device=dev).to(bf16)
        args = (x, gamma, beta, groups, 1e-5, wq, sw, static_scale(4.0), bias)
        for kw in ({}, {"temb": temb}, {"residual": res}):
            check(lambda: tfr.fused_gn_silu_conv3x3(*args, **kw),
                  lambda: tfr.fused_gn_silu_conv3x3_ref(*args, **kw), tfr.fused_gn_silu_conv3x3)
