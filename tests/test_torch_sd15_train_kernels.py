"""B14, the flash-attention backward, at head_dim 129-256 in the port
(ops.attention.flash_bwd_dkv / flash_bwd_dq and `_FlashAttention`, which the
SD1.5 UNet's head-160 self-attentions differentiate through in training).
Their plain versions are held against the JAX package's `_flash_bwd`, run
in Pallas interpret mode through `jax.vjp` of `flash_attention` (JAX pads
the head of 160 to 256 lanes; a count of `pallas_call` shows that the
kernels ran), in fp32 and in bf16; on a CUDA card only, the kernels against
their plain versions at 160 and 256, with causal, segment ids and GQA.

Inputs are made with numpy from a seed. The JAX package is imported through
a fixture, so that the `gpu` test also runs where only the port is
installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sd15_train_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.torch_port

SHAPE = (1, 128, 2, 160)  # one 128-row block of JAX's, head 160 padded to 256
# of |ref|max. fp32: summation order only (JAX's blocked kernels against
# whole rows; 9e-7 at most here). bf16: both sides round p and ds to bf16 for
# the products and the outputs to bf16, the sums in another order, so an
# output may round one bf16 ulp (2**-8 of its size) the other way: 5.7e-3 at
# most here
FP32_TOL, BF16_TOL = 5e-6, 1e-2


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 attn=importlib.import_module("paddlemix_tpu.ops.attention"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _inputs(seed, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(np.float32) for _ in range(4))  # q, k, v, do


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * float(np.abs(ref).max()))


def _jax_vjp(jx, monkeypatch, q, k, v, do, dtype):
    """(o, (dq, dk, dv)) of JAX's flash_attention through its custom_vjp, as
    float32 numpy; asserts the lse forward and the two backward kernels ran."""
    calls = []
    pallas_call = jx.attn.pl.pallas_call
    monkeypatch.setattr(jx.attn.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    args = tuple(jx.jnp.asarray(a, dtype) for a in (q, k, v))
    o, vjp = jx.jax.vjp(lambda *t: jx.attn.flash_attention(*t), *args)
    grads = vjp(jx.jnp.asarray(do, dtype))
    assert len(calls) == 3  # the lse forward, then the dkv and dq kernels
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    return f32(o), tuple(f32(g) for g in grads)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_backward_refs_at_head_dim_160_match_jax_pallas(jx, pallas_interpret, monkeypatch,
                                                        dtype):
    """flash_bwd_dkv_ref / flash_bwd_dq_ref from the port's lse form (qs, the
    base-2 lse, di = rowsum(o * do)) against JAX's dq, dk, dv."""
    jdt, tdt = ((jx.jnp.float32, torch.float32) if dtype == "fp32"
                else (jx.jnp.bfloat16, torch.bfloat16))
    q, k, v, do = _inputs(1)
    _, (jdq, jdk, jdv) = _jax_vjp(jx, monkeypatch, q, k, v, do, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    scale = SHAPE[3] ** -0.5
    qs = (tq.float() * (scale * tattn.LOG2E)).to(tdt)
    o, lse = tattn.flash_fwd_lse_ref(qs, tk, tv)
    di = (o.float() * tdo.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tattn.flash_bwd_dkv_ref(qs, tk, tv, tdo, lse, di)
    dq = tattn.flash_bwd_dq_ref(qs, tk, tv, tdo, lse, di, scale=scale)
    assert dq.dtype == dk.dtype == dv.dtype == tdt
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, ref, tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_grad_at_head_dim_160_matches_jax_pallas(jx, pallas_interpret,
                                                                 monkeypatch, dtype):
    """flash_attention under autograd on the CPU is `_FlashAttention` (the
    lse form and the backward's plain versions): its output and gradients
    against JAX's custom_vjp; no kernel launches on the CPU."""
    jdt, tdt = ((jx.jnp.float32, torch.float32) if dtype == "fp32"
                else (jx.jnp.bfloat16, torch.bfloat16))
    q, k, v, do = _inputs(2)
    jo, jgrads = _jax_vjp(jx, monkeypatch, q, k, v, do, jdt)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    for got, ref in zip((o,) + grads, (jo,) + jgrads):
        _close(got, ref, tol)
    assert tattn.flash_bwd_dkv.launches == 0 and tattn.flash_bwd_dq.launches == 0
    assert not tattn.flash_bwd_dkv.launches_by_dim and not tattn.flash_bwd_dq.launches_by_dim


# -------------------------------------------------------------- on the card
def _gate(out, ref, c):
    """|out - ref| <= 2**-7 |ref| + c |ref|max per element: chip_smoke.py's."""
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.gpu
def test_wide_head_backward_kernels_match_plain_versions_on_gpu():
    """B14 at head_dim 160 and 256 (and 200, padded to 256): MHA, and causal
    with segment ids and GQA; the kernels against their plain versions with
    chip_smoke.py's gate (c 4e-3), the control (di dropped) failing it; and
    flash_attention under autograd launching B15 and both B14 kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, h, kvh, d, causal in [(2, 256, 8, 8, 160, False), (1, 1024, 4, 4, 256, False),
                                    (2, 333, 8, 2, 160, True), (1, 300, 4, 2, 200, True)]:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        do = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
        segs = None
        if causal:
            seg = torch.ones((b, s), dtype=torch.int32, device=dev)
            seg[:, s // 3:] += 1
            seg[:, s - 50:] += 1
            segs = tattn.SegmentIds(seg, seg)
        kw = dict(causal=causal, segment_ids=segs)
        scale = d ** -0.5
        qs = (q.float() * scale * tattn.LOG2E).to(bf16)
        f32 = (qs.float(), k.float(), v.float(), do.float())
        ro, rlse = tattn.flash_fwd_lse_ref(*f32[:3], **kw)
        di = (ro * do.float()).sum(-1).transpose(1, 2).contiguous()
        before = (tattn.flash_bwd_dkv.launches, tattn.flash_bwd_dq.launches)
        dk, dv = tattn.flash_bwd_dkv(qs, k, v, do, rlse, di, **kw)
        dq = tattn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale, **kw)
        torch.cuda.synchronize()
        assert (tattn.flash_bwd_dkv.launches, tattn.flash_bwd_dq.launches) == \
            (before[0] + 1, before[1] + 1)
        rdk, rdv = tattn.flash_bwd_dkv_ref(*f32, rlse, di, **kw)
        rdq = tattn.flash_bwd_dq_ref(*f32, rlse, di, scale=scale, **kw)
        for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert got.shape == ref.shape and _gate(got, ref, 4e-3), (b, s, h, kvh, d)
        no_di = torch.zeros_like(di)
        assert not _gate(tattn.flash_bwd_dkv_ref(*f32, rlse, no_di, **kw)[0], rdk, 4e-3)
    q, k, v = (torch.randn((2, 256, 8, 160), generator=gen, device=dev).to(bf16)
               .requires_grad_() for _ in range(3))
    fns = (tattn.flash_fwd_lse, tattn.flash_bwd_dkv, tattn.flash_bwd_dq)
    before = [f.launches_by_dim[160] for f in fns]
    tattn.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches_by_dim[160] for f in fns] == [n + 1 for n in before]
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
