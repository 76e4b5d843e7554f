"""The training slice's kernels in the port: the flash forward with causal,
segment ids, GQA and the lse (B1, B15; ops.attention.flash_attention and
flash_attention_with_lse), the flash backward (B14, flash_bwd_dkv and
flash_bwd_dq, under autograd through `_FlashAttention`) and RMSNorm's
backward (B11, ops.norms.rms_norm_backward). Their plain versions are held
against the JAX package's Pallas kernels, run in interpret mode (a count of
`pallas_call` shows that the kernels really ran): the forward and `jax.grad`
through the JAX custom_vjps. Also the three kinds of gradient the kernel
wrappers give (ops.autograd), the head_dim route, and, on a CUDA card only,
each kernel against its plain version and the three kinds on the card.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import autograd as tautograd
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port

# fp32 on both sides: the two differ by summation order only (the JAX kernels
# run blocked online softmax, the plain versions whole rows)
FWD_TOL, BWD_TOL = 2e-5, 5e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    mod = importlib.import_module
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, attn=mod("paddlemix_tpu.ops.attention"),
                                 norms=mod("paddlemix_tpu.ops.norms"))


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


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _segments(b, s, cuts):
    """(B, S) int32 ids: row i changes segment at each of cuts[i]."""
    seg = np.zeros((b, s), np.int32)
    for i, row in enumerate(cuts):
        for c in row:
            seg[i, c:] += 1
    return seg + 1


# S 256 with 128-row blocks (two query and two key tiles: causal skips one),
# D 64, 4 query heads on 2 kv heads; segments cut mid-tile and on a tile edge
CASES = {"causal-seg-gqa": (True, True, 2), "causal-gqa": (True, False, 2),
         "seg-gqa": (False, True, 2), "causal-seg-mha": (True, True, 1)}


def _inputs(seed, group, b=2, s=256, h=4, d=64):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, h // group, d).astype(np.float32)
    v = rs.randn(b, s, h // group, d).astype(np.float32)
    do = rs.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do, _segments(b, s, [[77, 128, 200], [31]])


@pytest.mark.parametrize("causal,segments,group", list(CASES.values()), ids=list(CASES))
def test_flash_forward_with_lse_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, causal,
                                                       segments, group):
    q, k, v, _, seg = _inputs(1, group)
    jseg = jx.attn.SegmentIds(jx.jnp.asarray(seg), jx.jnp.asarray(seg)) if segments else None
    calls = _count_pallas_calls(monkeypatch, jx.attn)
    jo, jlse = jx.attn.flash_attention_with_lse(
        *(jx.jnp.asarray(a) for a in (q, k, v)), segment_ids=jseg, causal=causal, block_q=128,
        block_k=128)
    assert len(calls) == 1
    tseg = tattn.SegmentIds(torch.from_numpy(seg), torch.from_numpy(seg)) if segments else None
    o, lse = tattn.flash_attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                            segment_ids=tseg, causal=causal)
    assert lse.shape == (2, 256, 4) and lse.dtype == torch.float32
    _close(o, jo, FWD_TOL)
    _close(lse, jlse, FWD_TOL)  # base 2, as the JAX kernel writes it
    # the inference form (no lse) is the same function
    _close(tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                 segment_ids=tseg), jo, FWD_TOL)
    assert tattn.flash_fwd_lse.launches == 0 and tattn.flash_attention.launches == 0


@pytest.mark.parametrize("causal,segments,group", list(CASES.values()), ids=list(CASES))
def test_flash_backward_ref_matches_jax_grad_through_pallas(jx, pallas_interpret, monkeypatch,
                                                            causal, segments, group):
    q, k, v, do, seg = _inputs(2, group)
    jseg = jx.attn.SegmentIds(jx.jnp.asarray(seg), jx.jnp.asarray(seg)) if segments else None

    def jloss(q_, k_, v_):
        o = jx.attn.flash_attention(q_, k_, v_, causal=causal, segment_ids=jseg, block_q=128,
                                    block_k=128)
        return (o * jx.jnp.asarray(do)).sum()

    calls = _count_pallas_calls(monkeypatch, jx.attn)
    jgrads = jx.jax.grad(jloss, argnums=(0, 1, 2))(*(jx.jnp.asarray(a) for a in (q, k, v)))
    assert len(calls) == 3  # the lse forward, then the dkv and dq kernels
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tseg = tattn.SegmentIds(torch.from_numpy(seg), torch.from_numpy(seg)) if segments else None
    o = tattn.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, jg in zip(grads, jgrads):
        _close(g, jg, BWD_TOL)
    assert tattn.flash_bwd_dkv.launches == 0 and tattn.flash_bwd_dq.launches == 0


def test_flash_backward_refs_are_the_math_gradient():
    """dq/dk/dv of the plain backward against autograd through math
    attention (causal, segments, GQA); both compute in fp32."""
    q, k, v, do, seg = (torch.from_numpy(a) for a in _inputs(3, 2, s=96, d=32))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    segs = tattn.SegmentIds(seg.long(), seg.long())
    out = tattn.attention_math(q, k, v, causal=True, segment_ids=segs)
    want = torch.autograd.grad(out, (q, k, v), do)
    scale = 32 ** -0.5
    qs = q.detach() * scale * tattn.LOG2E
    o, lse = tattn.flash_fwd_lse_ref(qs, k.detach(), v.detach(), causal=True, segment_ids=segs)
    di = (o * do).sum(-1).transpose(1, 2)
    dk, dv = tattn.flash_bwd_dkv_ref(qs, k.detach(), v.detach(), do, lse, di, causal=True,
                                     segment_ids=segs)
    dq = tattn.flash_bwd_dq_ref(qs, k.detach(), v.detach(), do, lse, di, scale=scale,
                                causal=True, segment_ids=segs)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-6)


def test_rms_norm_backward_ref_matches_jax_grad_through_pallas(jx, pallas_interpret, monkeypatch):
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 64, 256) * 3).astype(np.float32)  # 128 rows: JAX takes its kernels
    w = (1 + 0.1 * rs.randn(256)).astype(np.float32)
    g = rs.randn(2, 64, 256).astype(np.float32)
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    jdx, jdw = jx.jax.grad(lambda x_, w_: (jx.norms.rms_norm(x_, w_, 1e-5) * g).sum(),
                           argnums=(0, 1))(jx.jnp.asarray(x), jx.jnp.asarray(w))
    assert len(calls) == 2  # forward and backward kernels
    dx, dw = tnorms.rms_norm_backward_ref(*(torch.from_numpy(a) for a in (x, w, g)), 1e-5)
    _close(dx, jdx, 1e-6)
    _close(dw, jdw, 1e-6)
    assert tnorms.rms_norm_backward_ref(*(torch.from_numpy(a) for a in (x, w, g)), 1e-5,
                                        need_dw=False)[1] is None
    # under autograd rms_norm is the custom function, whose backward is the plain one here
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = tnorms.rms_norm(tx, tw, 1e-5)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    adx, adw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    torch.testing.assert_close(adx, dx)
    torch.testing.assert_close(adw, dw)
    assert tnorms.rms_norm_backward.launches == 0


# -------------------------------------------------- the three kinds of gradient
def test_with_plain_backward_takes_the_plain_versions_gradient():
    """A kernel's output carries no graph; its backward is autograd of the
    plain version recomputed, for each input that needs it."""
    x = torch.randn(3, 5, requires_grad=True)
    w = torch.randn(5)
    y = tautograd.with_plain_backward(lambda a, b: (a * b).detach() + 0.0, lambda a, b: a * b,
                                      x, w)
    (gx,) = torch.autograd.grad(y.sum(), (x,))
    torch.testing.assert_close(gx, w.expand(3, 5))
    with torch.no_grad():  # nothing to record: the kernel alone
        assert tautograd.with_plain_backward(lambda a, b: a + 1, None, x, w).grad_fn is None


def test_refuse_grad_raises_only_when_autograd_records():
    x = torch.randn(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tautograd.refuse_grad("kernel", x, None)
    with torch.no_grad():
        tautograd.refuse_grad("kernel", x)
    tautograd.refuse_grad("kernel", x.detach())


# ------------------------------------------------------------ head_dim route
@pytest.mark.parametrize("d", [192, 256])
def test_head_dims_above_the_kernels_route_to_math(monkeypatch, d):
    """The JAX rule sends head_dim up to 256 to flash; the kernels are built
    up to 128, so the port's rule sends 129-256 to math attention."""
    def no_flash(*a, **kw):
        raise AssertionError("routed to the flash kernel")

    monkeypatch.setattr(tattn, "flash_attention", no_flash)
    rs = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rs.randn(1, 128, 2, d).astype(np.float32)).bfloat16()
               for _ in range(3))
    assert not tattn.use_flash(q.shape, k.shape)
    out = tattn.scaled_dot_product_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, tattn.attention_math(q, k, v, causal=True), rtol=0, atol=0)
    assert tattn.use_flash(q.shape[:3] + (128,), k.shape[:3] + (128,))


# -------------------------------------------------------------- on the card
def _counted(fn, *args, **kwargs):
    before = fn.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1, fn.__name__
    return out


@pytest.mark.gpu
def test_train_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    # the per-element gate of chip_smoke.py: 2**-7 |ref| + c |ref|max, c 4e-3
    # for the flash kernels (sound kernels need <= 1.6e-3, PERF.md)
    def within(out, ref, c):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())

    # flash: ragged lengths, head dims 64 (and 80, padded to 96), MHA and GQA,
    # causal with segments
    for b, s, h, kvh, d, causal in [(2, 333, 4, 2, 64, True), (1, 256, 8, 8, 80, False),
                                    (1, 512, 8, 2, 128, True)]:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        do = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
        seg = torch.ones((b, s), dtype=torch.int32, device=dev)
        seg[:, s // 3:] += 1
        seg[:, s - 50:] += 1
        segs = tattn.SegmentIds(seg, seg)
        scale = d ** -0.5
        qs = (q.float() * scale * tattn.LOG2E).to(bf16)
        o, lse = _counted(tattn.flash_fwd_lse, qs, k, v, causal=causal, segment_ids=segs)
        ro, rlse = tattn.flash_fwd_lse_ref(qs, k, v, causal=causal, segment_ids=segs)
        assert within(o, ro, 4e-3) and torch.allclose(lse, rlse, atol=1e-3), (b, s, h, kvh, d)
        di = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = _counted(tattn.flash_bwd_dkv, qs, k, v, do, rlse, di, causal=causal,
                          segment_ids=segs)
        rdk, rdv = tattn.flash_bwd_dkv_ref(qs, k, v, do, rlse, di, causal=causal,
                                           segment_ids=segs)
        dq = _counted(tattn.flash_bwd_dq, qs, k, v, do, rlse, di, scale=scale, causal=causal,
                      segment_ids=segs)
        rdq = tattn.flash_bwd_dq_ref(qs, k, v, do, rlse, di, scale=scale, causal=causal,
                                     segment_ids=segs)
        for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert got.shape == ref.shape and within(got, ref, 4e-3), (b, s, h, kvh, d)
    # RMSNorm backward, with and without dw
    x = torch.randn((300, 4096), generator=gen, device=dev).to(bf16)
    w = 1 + 0.1 * torch.randn(4096, generator=gen, device=dev)
    g = torch.randn((300, 4096), generator=gen, device=dev).to(bf16)
    dx, dw = _counted(tnorms.rms_norm_backward, x, w, g, 1e-5)
    rdx, rdw = tnorms.rms_norm_backward_ref(x, w, g, 1e-5)
    assert within(dx, rdx, 1e-3) and torch.allclose(dw, rdw, rtol=1e-4, atol=1e-3)
    dx2, none = _counted(tnorms.rms_norm_backward, x, w, g, 1e-5, need_dw=False)
    assert none is None and torch.equal(dx2, dx)


@pytest.mark.gpu
def test_kernel_gradients_on_gpu():
    """The three kinds on the card: flash and RMSNorm differentiate through
    their backward kernels; adaLN (B12) through autograd of its plain
    version; an inference kernel (B6) refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    from paddlemix_tpu_torch.ops import quant as tquant

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((1, 256, 4, 64), generator=gen, device=dev).to(bf16).requires_grad_()
               for _ in range(3))
    counts = [f.launches for f in (tattn.flash_fwd_lse, tattn.flash_bwd_dkv, tattn.flash_bwd_dq)]
    o = tattn.flash_attention(q, k, v, causal=True)
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (tattn.flash_fwd_lse, tattn.flash_bwd_dkv,
                                 tattn.flash_bwd_dq)] == [c + 1 for c in counts]
    x = torch.randn((64, 1024), generator=gen, device=dev).to(bf16).requires_grad_()
    w = torch.ones(1024, device=dev, requires_grad=True)
    before = tnorms.rms_norm_backward.launches
    tnorms.rms_norm(x, w, 1e-5).float().sum().backward()
    torch.cuda.synchronize()
    assert tnorms.rms_norm_backward.launches == before + 1 and w.grad is not None
    xa = torch.randn((2, 64, 1536), generator=gen, device=dev).to(bf16).requires_grad_()
    sc, sh = (torch.randn((2, 1536), generator=gen, device=dev).to(bf16).requires_grad_()
              for _ in range(2))
    y = tnorms.adaptive_layer_norm(xa, sc, sh)
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, (xa, sc, sh), gy)
    want = torch.autograd.grad(tnorms.adaptive_layer_norm_ref(xa, sc, sh), (xa, sc, sh), gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    wq, scale = tquant.quantize_weights_int8(torch.randn((256, 512), device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        tquant.wint8_matmul(torch.randn((4, 512), device=dev).to(bf16).requires_grad_(), wq,
                            scale)
