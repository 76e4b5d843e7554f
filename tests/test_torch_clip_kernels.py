"""The CLIP slice's kernel in the port: LayerNorm (B10, ops.norms.layer_norm)
and its backward (ops.norms.layer_norm_backward, under autograd through
`_LayerNorm`). Their plain versions are held against the JAX package's
Pallas kernels, run in interpret mode (a count of `pallas_call` shows that
the kernels really ran; the JAX side takes them only at widths a multiple of
128 and 64 rows or more, else XLA): the forward and `jax.grad` through the
JAX custom_vjp. Also the autograd kind (a backward of its own: the kernel on
a card, the plain version on the CPU) and, on a CUDA card only, both kernels
against their plain versions.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_clip_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port

# fp32 on both sides: the sums' order differs (the JAX kernel's blocks), ~1e-7
# of the values. bf16 output: both round the same fp32 math once, so they are
# at most one bf16 rounding step apart (2**-7 |value|) where the fp32 values
# straddle a rounding boundary.
FP32_TOL, BF16_ULP = 2e-6, 2.0 ** -7


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 norms=importlib.import_module("paddlemix_tpu.ops.norms"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _count_pallas_calls(monkeypatch, module):
    calls = []
    pallas_call = module.pl.pallas_call
    monkeypatch.setattr(module.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    return calls


def _inputs(seed, rows, h):
    """Rows with their own offsets and scales (a residual stream's), so that
    the mean matters; fp32 weight and bias near 1 and 0."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, h) * rs.uniform(0.5, 3, (rows, 1)) + rs.randn(rows, 1) * 2)
    w = 1 + 0.2 * rs.randn(h)
    b = 0.2 * rs.randn(h)
    g = rs.randn(rows, h)
    return [a.astype(np.float32) for a in (x, w, b, g)]


def _close(out, ref, dtype):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else \
        np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=FP32_TOL * max(1.0, np.abs(ref).max()))
    else:
        assert (np.abs(out - ref) <= BF16_ULP * np.abs(ref) + 1e-6).all(), \
            np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 256), (192, 512)], ids=["128x256", "192x512"])
def test_layer_norm_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, dtype, shape):
    x, w, b, _ = _inputs(shape[0] + shape[1], *shape)
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    ref = jx.norms.layer_norm(jx.jnp.asarray(x).astype(dtype), jx.jnp.asarray(w),
                              jx.jnp.asarray(b), 1e-5)
    assert len(calls) == 1 and ref.dtype == jx.jnp.dtype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = tnorms.layer_norm_ref(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert out.dtype == tx.dtype
    _close(out, np.asarray(ref, np.float32), dtype)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    wrapped = tnorms.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert torch.equal(wrapped, out) and tnorms.layer_norm.launches == 0


def test_layer_norm_ref_is_two_pass_as_the_jax_reference(jx):
    """At a large offset E[x^2] - E[x]^2 loses the variance in fp32; the
    plain version, as `layer_norm_xla`, subtracts the mean first."""
    rs = np.random.RandomState(0)
    x = (1000 + rs.randn(4, 256)).astype(np.float32)
    ref = jx.norms.layer_norm_xla(jx.jnp.asarray(x), None, None, 1e-5)
    out = tnorms.layer_norm_ref(torch.from_numpy(x), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    assert abs(float(out.std(dim=-1).mean()) - 1.0) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_ref_matches_jax_grad_through_pallas(jx, pallas_interpret,
                                                                monkeypatch, dtype):
    x, w, b, g = _inputs(7, 128, 256)  # 128 rows: JAX takes its kernels
    x, g = (a.reshape(2, 64, 256) for a in (x, g))
    jxx, jg = (jx.jnp.asarray(a).astype(dtype) for a in (x, g))
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    jdx, jdw, jdb = jx.jax.grad(
        lambda x_, w_, b_: (jx.norms.layer_norm(x_, w_, b_, 1e-5).astype(jx.jnp.float32)
                            * jg.astype(jx.jnp.float32)).sum(),
        argnums=(0, 1, 2))(jxx, jx.jnp.asarray(w), jx.jnp.asarray(b))
    assert len(calls) == 2  # forward and backward kernels
    assert jdx.dtype == jx.jnp.dtype(dtype) and jdw.dtype == jdb.dtype == jx.jnp.float32
    tdt = getattr(torch, dtype)
    tx, tg = (torch.tensor(np.asarray(a.astype(jx.jnp.float32))).to(tdt) for a in (jxx, jg))
    dx, dw, db = tnorms.layer_norm_backward_ref(tx, torch.from_numpy(w), tg, 1e-5)
    assert dx.dtype == tdt and dw.dtype == db.dtype == torch.float32
    _close(dx, np.asarray(jdx, np.float32), dtype)
    # dw and db: fp32 sums over 128 rows, in another order than the JAX grid's
    for got, want in ((dw, jdw), (db, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # under autograd layer_norm is the custom function, whose backward is the
    # plain one on the CPU
    ax, aw, ab = (t.clone().requires_grad_() for t in (tx, torch.from_numpy(w),
                                                        torch.from_numpy(b)))
    y = tnorms.layer_norm(ax, aw, ab, 1e-5)
    assert type(y.grad_fn).__name__ == "_LayerNormBackward"
    for got, want in zip(torch.autograd.grad(y, (ax, aw, ab), tg), (dx, dw, db)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tnorms.layer_norm_backward.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_at_eva_width_matches_jax_pallas(jx, pallas_interpret, monkeypatch, dtype):
    """EVA's sub-LN `ffn_ln` rows, 2,048 wide (the wide form on the card):
    the plain forward and backward against the JAX kernels in interpret mode
    (64 rows: JAX takes its kernels)."""
    x, w, b, g = _inputs(11, 64, 2048)
    jxx, jg = (jx.jnp.asarray(a).astype(dtype) for a in (x, g))
    jw, jb = jx.jnp.asarray(w), jx.jnp.asarray(b)
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    ref = jx.norms.layer_norm(jxx, jw, jb, 1e-5)
    jdx, jdw, jdb = jx.jax.grad(
        lambda x_, w_, b_: (jx.norms.layer_norm(x_, w_, b_, 1e-5).astype(jx.jnp.float32)
                            * jg.astype(jx.jnp.float32)).sum(),
        argnums=(0, 1, 2))(jxx, jw, jb)
    assert len(calls) == 3  # the forward alone, then forward and backward under grad
    tdt = getattr(torch, dtype)
    tx, tg = (torch.tensor(np.asarray(a.astype(jx.jnp.float32))).to(tdt) for a in (jxx, jg))
    out = tnorms.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    _close(out, np.asarray(ref, np.float32), dtype)
    dx, dw, db = tnorms.layer_norm_backward(tx, torch.from_numpy(w), tg, 1e-5)
    _close(dx, np.asarray(jdx, np.float32), dtype)
    for got, want in ((dw, jdw), (db, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert tnorms.layer_norm.launches == tnorms.layer_norm_backward.launches == 0


def test_layer_norm_autograd_kind_takes_its_own_backward(monkeypatch):
    """A backward of its own, as flash and RMSNorm have: `_LayerNorm` calls
    `layer_norm_backward` (the kernel on a card, the plain version here) once
    a call, and hands back only the gradients autograd asks for; its
    gradients equal autograd of torch's LayerNorm."""
    calls = []
    backward = tnorms.layer_norm_backward
    monkeypatch.setattr(tnorms, "layer_norm_backward",
                        lambda *a, **kw: calls.append(1) or backward(*a, **kw))
    x, w, b, g = (torch.from_numpy(a) for a in _inputs(3, 96, 320))  # 320: not a 128 multiple
    ax, aw, ab = (t.clone().requires_grad_() for t in (x, w, b))
    got = torch.autograd.grad(tnorms.layer_norm(ax, aw, ab, 1e-5), (ax, aw, ab), g)
    rx, rw, rb = (t.clone().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(torch.nn.functional.layer_norm(rx, (320,), rw, rb, 1e-5),
                               (rx, rw, rb), g)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    # the weight alone: one backward call, no gradient for x or the bias
    aw = w.clone().requires_grad_()
    y = tnorms.layer_norm(x, aw, b, 1e-5)
    (gw,) = torch.autograd.grad(y, (aw,), g)
    torch.testing.assert_close(gw, want[1], rtol=1e-5, atol=1e-5)
    assert len(calls) == 2
    with torch.no_grad():  # nothing to record: no custom function
        assert tnorms.layer_norm(ax, aw, ab, 1e-5).grad_fn is None


def test_layer_norm_refuses_what_is_not_ported():
    x = torch.randn(4, 8)
    with pytest.raises(NotImplementedError, match="without weight or bias"):
        tnorms.layer_norm(x, torch.ones(8), None)
    with pytest.raises(ValueError, match="unsupported device"):
        tnorms.layer_norm(x.to("meta"), torch.ones(8, device="meta"),
                          torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tnorms.layer_norm_backward(x.to("meta"), torch.ones(8, device="meta"),
                                   x.to("meta"))
    # the kernels' own check: the dtypes and widths a path gives them
    tnorms._ln_check("layer_norm", x.to(torch.bfloat16), (torch.ones(8), torch.zeros(8)))
    tnorms._ln_check("layer_norm", torch.randn(4, 2048), (torch.ones(2048), torch.zeros(2048)))
    for bad in (x.half(), torch.randn(4, 2049)):
        with pytest.raises(ValueError, match="bf16/fp32 rows at most 2048 wide"):
            tnorms._ln_check("layer_norm", bad, ())


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_layer_norm_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    # the per-element gate of chip_smoke.py: 2**-7 |ref| + c |ref|max
    def within(out, ref, c):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())

    def counted(fn, *args):
        before = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, fn.__name__
        return out

    # rows of ViT-B/16, a ragged count at bigG's 1280, the pooled rows (a
    # strided slice of the tokens), fp32 rows; the forward's forms: the warp
    # form at many rows of at most 4 chunks a lane (5000 x 768, 1500 x 1024),
    # the row form elsewhere (bf16 and fp32, pooled), the one-element form at
    # a width of no whole 16 bytes
    for rows, h, pooled, dtype in [(1000, 768, False, bf16), (77, 1280, False, bf16),
                                   (64, 768, True, bf16), (300, 512, False, torch.float32),
                                   (5000, 768, False, bf16), (3001, 1280, True, torch.float32),
                                   (2000, 100, False, bf16), (1500, 1024, False, bf16)]:
        base = torch.randn((rows, 3 if pooled else 1, h), generator=gen, device=dev)
        x = (2 * base + torch.randn((rows, 1, 1), generator=gen, device=dev)).to(dtype)[:, 0]
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        g = torch.randn((rows, h), generator=gen, device=dev).to(dtype)
        y = counted(tnorms.layer_norm, x, w, b, 1e-5)
        plan = tnorms.layer_norm_plan_of(x, w, b)
        assert y.dtype == dtype and y.shape == x.shape
        assert within(y, tnorms.layer_norm_ref(x.float(), w, b, 1e-5), 1e-6), (rows, h, plan)
        assert torch.equal(y, tnorms.layer_norm(x, w, b, 1e-5)), plan  # launches bit-identical
        xm = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape).copy_(x)
        assert within(tnorms.layer_norm(xm, w.to(bf16), b, 1e-5),
                      tnorms.layer_norm_ref(xm.float(), w.to(bf16), b, 1e-5), 1e-6), (rows, h)
        es = x.element_size()
        for aligned in (True, False):
            assert tnorms.layer_norm_plan(rows, h, es, aligned) == \
                tnorms.layer_norm_plan_library(rows, h, dtype, aligned)
        dx, dw, db = counted(tnorms.layer_norm_backward, x, w, g, 1e-5)
        rdx, rdw, rdb = tnorms.layer_norm_backward_ref(x.float(), w, g.float(), 1e-5)
        assert dx.dtype == dtype and within(dx, rdx, 1e-5), (rows, h)
        for got, ref in ((dw, rdw), (db, rdb)):
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), (rows, h)
    # under autograd on the card: the backward kernel, once
    x = torch.randn((256, 768), generator=gen, device=dev).to(bf16).requires_grad_()
    w = torch.ones(768, device=dev, requires_grad=True)
    b = torch.zeros(768, device=dev, requires_grad=True)
    before = tnorms.layer_norm_backward.launches
    tnorms.layer_norm(x, w, b, 1e-5).float().square().sum().backward()
    torch.cuda.synchronize()
    assert tnorms.layer_norm_backward.launches == before + 1
    assert x.grad is not None and w.grad is not None and b.grad is not None


@pytest.mark.gpu
def test_layer_norm_wide_rows_match_plain_versions_on_gpu():
    """B10 at EVA's 2,048-wide rows and the wide form's other plans (a ragged
    width, one cluster, fp32 rows with one ring stage, the one-element form,
    the narrowest wide width), forward and backward per element against the
    plain versions, the plans against the library's, two backward launches
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def within(out, ref, c):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())

    for rows, h, misaligned, dtype in [(50432, 2048, False, bf16), (1000, 1960, False, bf16),
                                       (77, 2048, False, bf16), (3000, 2048, False, torch.float32),
                                       (500, 2048, True, bf16), (5000, 1288, False, bf16)]:
        x = (2 * torch.randn((rows, h), generator=gen, device=dev)
             + torch.randn((rows, 1), generator=gen, device=dev)).to(dtype)
        g = torch.randn((rows, h), generator=gen, device=dev).to(dtype)
        if misaligned:  # one element past a 16-byte boundary
            x, g = (torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(t.shape).copy_(t)
                    for t in (x, g))
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        es = x.element_size()
        plan = tnorms.layer_norm_bwd_plan(rows, h, es, not misaligned)
        assert plan.epl == tnorms.LN_WIDE_EPL and plan == \
            tnorms.layer_norm_bwd_plan_library(rows, h, dtype, not misaligned)
        assert tnorms.layer_norm_plan(rows, h, es, not misaligned) == \
            tnorms.layer_norm_plan_library(rows, h, dtype, not misaligned)
        y = tnorms.layer_norm(x, w, b, 1e-5)
        dx, dw, db = tnorms.layer_norm_backward(x, w, g, 1e-5)
        torch.cuda.synchronize()
        assert within(y, tnorms.layer_norm_ref(x.float(), w, b, 1e-5), 1e-6), (rows, h)
        rdx, rdw, rdb = tnorms.layer_norm_backward_ref(x.float(), w, g.float(), 1e-5)
        assert dx.dtype == dtype and within(dx, rdx, 1e-5), (rows, h)
        for got, ref in ((dw, rdw), (db, rdb)):
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), (rows, h)
        again = tnorms.layer_norm_backward(x, w, g, 1e-5)
        assert all(torch.equal(a, b_) for a, b_ in zip((dx, dw, db), again)), (rows, h)
