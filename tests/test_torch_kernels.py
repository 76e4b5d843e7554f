"""Port kernels (paddlemix_tpu_torch.ops): plain versions against the JAX
package's Pallas kernels (interpret mode), among them B1's wide heads
(head_dim 129-256) and its int8 QK^T form, the flash/math routing rule against
the JAX rule, and, on a CUDA card only, each kernel against its plain version.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from paddlemix_tpu.ops import attention, norms

    return types.SimpleNamespace(jnp=jnp, attn=attention, norms=norms)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = np.asarray(out, dtype=np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 200, 2, 64)], ids=["aligned", "ragged"])
def test_flash_ref_matches_jax_flash_interpret(jx, pallas_interpret, shape):
    q, k, v = _qkv(shape)
    ref = jx.attn.flash_attention(*(jx.jnp.asarray(a) for a in (q, k, v)))
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    # fp32 both sides: only summation order differs
    _assert_close(ref, out, tol=1e-5)
    assert tattn.flash_attention.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_attention_math_matches_attention_xla(jx, causal):
    q, k, v = _qkv((2, 77, 4, 32), seed=1)
    ref = jx.attn.attention_xla(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal)
    out = tattn.attention_math(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    _assert_close(ref, out, tol=1e-5)


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("c,groups", [(64, 8), (96, 32)])
def test_group_norm_ref_matches_jax_pallas_interpret(jx, pallas_interpret, monkeypatch, act,
                                                     c, groups):
    monkeypatch.setenv("PADDLEMIX_PALLAS_GROUPNORM", "1")
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 16, 16, c) * 2.0 + 0.5).astype(np.float32)  # 256 rows: Pallas path
    w = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    ref = jx.norms.group_norm(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b), groups,
                              1e-5, act=act)
    out = tnorms.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            groups, 1e-5, act=act)
    _assert_close(ref, out, tol=1e-5)
    assert tnorms.group_norm.launches == 0


def test_group_norm_ref_rank2_matches_xla(jx):
    rs = np.random.RandomState(3)
    x = rs.randn(3, 64).astype(np.float32)
    w, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    ref = jx.norms.group_norm_silu_xla(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b),
                                       8, 1e-5)
    out = tnorms.group_norm_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                8, 1e-5, act="silu")
    _assert_close(ref, out, tol=1e-5)


# (q_shape, k_shape, causal, route): the SDXL-1024 attention calls, and one
# call of each later slice (SD3's joint attention, LLaVA's ViT, the Llama
# int8-cache prefill, the SFT micro-batch, SD1.5-512's head_dim-160 blocks and
# mid block), and the edges of the head_dim rule
_ROUTED_CALLS = {
    "unet_self_64x64": ((2, 4096, 10, 64), (2, 4096, 10, 64), False, "flash"),
    "unet_self_32x32": ((2, 1024, 20, 64), (2, 1024, 20, 64), False, "flash"),
    "unet_cross_77": ((2, 4096, 10, 64), (2, 77, 10, 64), False, "math"),
    "vae_mid_d512": ((1, 16384, 1, 512), (1, 16384, 1, 512), False, "math"),
    "clip_causal_77": ((2, 77, 20, 64), (2, 77, 20, 64), True, "math"),
    "sd3_joint_4250": ((2, 4250, 24, 64), (2, 4250, 24, 64), False, "flash"),
    "llava_vit_577": ((1, 577, 16, 64), (1, 577, 16, 64), False, "math"),
    "llama_prefill_3968": ((1, 3968, 32, 128), (1, 3968, 32, 128), True, "flash"),
    "llama_sft_2048": ((2, 2048, 32, 128), (2, 2048, 32, 128), True, "flash"),
    "sd15_self_d160": ((2, 256, 8, 160), (2, 256, 8, 160), False, "flash"),
    "sd15_mid_d160_64": ((2, 64, 8, 160), (2, 64, 8, 160), False, "math"),
    "d256": ((1, 256, 2, 256), (1, 256, 2, 256), False, "flash"),
    "d288": ((1, 256, 2, 288), (1, 256, 2, 288), False, "math"),
}


@pytest.mark.parametrize("call", sorted(_ROUTED_CALLS))
def test_routing_rule_matches_jax(jx, pallas_interpret, monkeypatch, call):
    q_shape, k_shape, causal, expected = _ROUTED_CALLS[call]
    taken = []
    monkeypatch.setattr(jx.attn, "flash_attention", lambda q, *a, **kw: taken.append("flash") or q)
    monkeypatch.setattr(jx.attn, "attention_xla", lambda q, *a, **kw: taken.append("math") or q)
    q = jx.jnp.zeros(q_shape, jx.jnp.bfloat16)
    k = jx.jnp.zeros(k_shape, jx.jnp.bfloat16)
    jx.attn.scaled_dot_product_attention(q, k, k, causal=causal)

    monkeypatch.setattr(tattn, "flash_attention", lambda q, *a, **kw: taken.append("flash") or q)
    monkeypatch.setattr(tattn, "attention_math", lambda q, *a, **kw: taken.append("math") or q)
    tq = torch.empty(q_shape, dtype=torch.bfloat16, device="meta")
    tk = torch.empty(k_shape, dtype=torch.bfloat16, device="meta")
    tattn.scaled_dot_product_attention(tq, tk, tk, causal=causal)
    assert taken[0] == taken[1], (call, taken)
    assert taken[0] == expected


def test_cpu_tensors_never_launch_a_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 128, 2, 64), seed=4))
    tattn.scaled_dot_product_attention(q, k, v)
    tattn.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    x = torch.randn(1, 8, 8, 64, generator=torch.Generator().manual_seed(0))
    tnorms.group_norm(x, torch.ones(64), torch.zeros(64), 32, act="silu")
    assert tattn.flash_attention.launches == 0
    assert tnorms.group_norm.launches == 0


# ------------------------------------------------- B1's head_dim 129-256
@pytest.mark.parametrize("d", [160, 256])
def test_wide_head_sdpa_matches_jax_flash_interpret(jx, pallas_interpret, monkeypatch, d):
    """Both packages route (1, 256, 2, d) to flash (JAX pads the head to 256
    lanes, the port to its kernel width); fp32 both sides."""
    q, k, v = _qkv((1, 256, 2, d), seed=5)
    ref = jx.attn.scaled_dot_product_attention(*(jx.jnp.asarray(a) for a in (q, k, v)))
    ref_flash = jx.attn.flash_attention(*(jx.jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ref_flash))  # JAX took flash
    taken = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: taken.append(kw) or real(*a, **kw))
    out = tattn.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert len(taken) == 1
    _assert_close(ref, out, tol=1e-5)
    assert real.launches == 0


def test_wide_head_grad_on_cpu(jx):
    """Under autograd a head_dim-160 call differentiates on the CPU through
    the lse form and the backward's plain versions (on the card through B15
    and B14); the gradients match JAX's of attention_xla."""
    jax = pytest.importorskip("jax")
    q, k, v = _qkv((1, 256, 2, 160), seed=6)
    do = np.random.RandomState(7).randn(1, 256, 2, 160).astype(np.float32)

    def loss(q, k, v):
        return (jx.attn.attention_xla(q, k, v) * do).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jx.jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv)
    (out * torch.from_numpy(do)).sum().backward()
    for r, t in zip(ref, (tq, tk, tv)):
        _assert_close(r, t.grad, tol=1e-5)


# ----------------------------------------------------------- int8 QK^T
# (q heads, kv heads, d, causal, segments): JAX's own cases
# (tests/test_ops.py::test_flash_attention_int8_qk) and SD1.5's widest head
_INT8_CASES = {
    "plain": (2, 2, 64, False, False),
    "causal": (2, 2, 64, True, False),
    "gqa_segments": (4, 2, 64, False, True),
    "d160": (2, 2, 160, False, False),
}


def _int8_inputs(jx, case):
    hq, hkv, d, causal, segments = _INT8_CASES[case]
    rs = np.random.RandomState(8)
    q = rs.randn(1, 256, hq, d).astype(np.float32)
    k, v = (rs.randn(1, 256, hkv, d).astype(np.float32) for _ in range(2))
    seg = None
    if segments:  # three segments, the middle one ragged
        ids = np.repeat(np.arange(3, dtype=np.int32), [100, 90, 66])[None]
        seg = (ids, ids)
    return q, k, v, causal, seg


def _jax_int8(jx, monkeypatch, q, k, v, causal, seg):
    """JAX's int8 flash in interpret mode, and the operands its XLA prologue
    hands to the pallas_call (q8, k8, v, sq, sk, ...)."""
    seen = []
    real = jx.attn.pl.pallas_call

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*inputs):
            seen.append([np.asarray(x) for x in inputs])
            return call(*inputs)
        return run
    monkeypatch.setattr(jx.attn.pl, "pallas_call", spy)
    jseg = None if seg is None else jx.attn.SegmentIds(*(jx.jnp.asarray(s) for s in seg))
    out = jx.attn.flash_attention(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                  segment_ids=jseg, block_q=128, block_k=128, int8_qk=True)
    assert len(seen) == 1
    return np.asarray(out), seen[0]


@pytest.mark.parametrize("case", sorted(_INT8_CASES))
def test_int8_qk_operands_bit_exact(jx, pallas_interpret, monkeypatch, case):
    """The port's quantize (q8, k8) and row scales (sq with scale * log2(e)
    folded in, sk) equal JAX's prologue bit for bit."""
    q, k, v, causal, seg = _int8_inputs(jx, case)
    q8j, k8j, _, sqj, skj = _jax_int8(jx, monkeypatch, q, k, v, causal, seg)[1][:5]
    d = q.shape[3]
    assert q8j.dtype == np.int8 and k8j.dtype == np.int8
    q8, k8, sq, sk = tattn.int8_qk_operands(torch.from_numpy(q), torch.from_numpy(k), d ** -0.5)
    # JAX's layout is (B, H, S, D), its head padded to 256 lanes at d 160 (zeros)
    np.testing.assert_array_equal(q8.permute(0, 2, 1, 3).numpy(), q8j[..., :d])
    np.testing.assert_array_equal(k8.permute(0, 2, 1, 3).numpy(), k8j[..., :d])
    assert not q8j[..., d:].any()
    np.testing.assert_array_equal(sq.permute(0, 2, 1).numpy(), sqj[..., 0])
    np.testing.assert_array_equal(sk.permute(0, 2, 1).numpy(), skj[:, :, 0, :])


@pytest.mark.parametrize("case", sorted(_INT8_CASES))
def test_int8_qk_matches_jax_interpret(jx, pallas_interpret, monkeypatch, case):
    """flash_attention(int8_qk=True) on the CPU (the plain version) against
    JAX's int8 kernel in interpret mode: the same int8 scores, then fp32 both
    sides, so only summation order differs."""
    q, k, v, causal, seg = _int8_inputs(jx, case)
    ref, _ = _jax_int8(jx, monkeypatch, q, k, v, causal, seg)
    tseg = None if seg is None else tattn.SegmentIds(*(torch.from_numpy(s) for s in seg))
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                segment_ids=tseg, int8_qk=True)
    _assert_close(ref, out, tol=1e-5)
    assert tattn.flash_attention_int8.launches == 0


def test_int8_qk_switch_and_autograd(monkeypatch):
    """PMIX_INT8_ATTN=1 (JAX's switch) sends inference calls of
    flash_attention and scaled_dot_product_attention to the int8 form;
    int8_qk=False overrides it; under autograd the forward stays bf16 QK^T,
    as JAX's vjp does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 256, 2, 64), seed=9))
    int8 = tattn.flash_attention_int8_ref(q, k, v)
    bf16 = tattn.flash_attention_ref(q, k, v)
    assert (int8 - bf16).abs().max() > 1e-4  # the two forms differ
    monkeypatch.setenv("PMIX_INT8_ATTN", "1")
    assert torch.equal(tattn.flash_attention(q, k, v), int8)
    assert torch.equal(tattn.scaled_dot_product_attention(q, k, v), int8)
    assert torch.equal(tattn.flash_attention(q, k, v, int8_qk=False), bf16)
    qg = q.clone().requires_grad_()
    out = tattn.flash_attention(qg, k, v)
    torch.testing.assert_close(out.detach(), bf16, rtol=0, atol=1e-5)
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


def test_group_norm_rejects_indivisible_channels():
    with pytest.raises(ValueError):
        tnorms.group_norm(torch.zeros(1, 4, 4, 30), torch.ones(30), torch.zeros(30), 32)


def _excess(out, ref, c):
    """chip_smoke.py's per-element gate for B1: the excess of |out - ref| over
    2**-7 |ref| + c |ref|max (must be <= 0)."""
    ref = ref.float()
    return ((out.float() - ref).abs() - 2.0 ** -7 * ref.abs() - c * ref.abs().max()).max().item()


def _truncating_quantize(x):
    xf = x.float()
    a = xf.abs().amax(-1).clamp_min(1e-9)
    return torch.trunc(xf * (torch.full_like(a, 127.0) / a)[..., None]).clamp(
        -127, 127).to(torch.int8), a


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # B1 at head_dim 129-256 (read in place at 192 / 256), its lse form, and
    # the int8 QK^T form, with chip_smoke.py's gates (c 4e-3) and the int8
    # form's truncation control, which must fail
    for shape, hkv, causal, int8 in [((2, 256, 8, 160), 8, False, False),
                                     ((1, 300, 4, 200), 2, True, False),
                                     ((1, 256, 2, 256), 2, False, False),
                                     ((2, 256, 2, 64), 2, True, True),
                                     ((1, 300, 4, 64), 2, False, True),
                                     ((2, 256, 8, 160), 8, False, True)]:
        b, s, h, d = shape
        q = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        if int8:
            before = tattn.flash_attention_int8.launches
            out = tattn.flash_attention(q, k, v, causal=causal, int8_qk=True)
            torch.cuda.synchronize()
            assert tattn.flash_attention_int8.launches == before + 1
            ref = tattn.flash_attention_int8_ref(q, k, v, causal=causal)
            assert _excess(out, ref, 4e-3) <= 0, shape
            monkeypatch.setattr(tattn, "quantize_rows_int8", _truncating_quantize)
            assert _excess(tattn.flash_attention_int8_ref(q, k, v, causal=causal), ref,
                           4e-3) > 0, shape
            monkeypatch.undo()
            continue
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v, causal=causal, int8_qk=False)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        ref = tattn.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        assert _excess(out, ref, 4e-3) <= 0, shape
        qs = (q.float() * (d ** -0.5 * tattn.LOG2E)).to(torch.bfloat16)
        o, lse = tattn.flash_fwd_lse(qs, k, v, causal=causal)
        ro, rlse = tattn.flash_fwd_lse_ref(qs.float(), k.float(), v.float(), causal=causal)
        assert _excess(o, ro, 4e-3) <= 0 and (lse - rlse).abs().max().item() <= 1e-3, shape
        # under autograd: the lse forward, then both backward kernels (B14)
        fns = (tattn.flash_fwd_lse, tattn.flash_bwd_dkv, tattn.flash_bwd_dq)
        before = [f.launches for f in fns]
        qg = q.clone().requires_grad_()
        tattn.flash_attention(qg, k, v, causal=causal).float().sum().backward()
        torch.cuda.synchronize()
        assert [f.launches for f in fns] == [n + 1 for n in before], shape
        assert bool(torch.isfinite(qg.grad).all()), shape
    # the core at head_dim 64 and 128 at its edges: S below one 128-row
    # tile, q / k / v as strided views (slices of one joint tensor, as SD3's
    # joint attention gives, or a transpose of (B, H, S, D)), GQA 4:1, and
    # causal with the lse
    for b, s, h, hkv, d, causal, layout in [(1, 77, 4, 4, 64, False, "slices"),
                                            (2, 50, 8, 2, 128, True, "slices"),
                                            (1, 300, 8, 2, 64, True, "transposed"),
                                            (2, 141, 4, 1, 128, False, "transposed")]:
        if layout == "slices":
            x = torch.randn((b, s, h + 2 * hkv, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
        else:
            q = torch.randn((b, h, s, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16).transpose(1, 2)
            k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda",
                                dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
        assert not q.is_contiguous() and tattn._kernel_operand(q) is q  # read in place
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v, causal=causal, int8_qk=False)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        ref = tattn.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        assert _excess(out, ref, 4e-3) <= 0, (b, s, h, hkv, d, layout)
        qs = (q.float() * (d ** -0.5 * tattn.LOG2E)).to(torch.bfloat16)
        o, lse = tattn.flash_fwd_lse(qs, k, v, causal=causal)
        ro, rlse = tattn.flash_fwd_lse_ref(qs.float(), k.float(), v.float(), causal=causal)
        assert _excess(o, ro, 4e-3) <= 0 and (lse - rlse).abs().max().item() <= 1e-3, \
            (b, s, h, hkv, d, layout)
    for shape in [(2, 256, 4, 64), (1, 1000, 4, 64), (1, 300, 2, 32), (1, 130, 2, 80),
                  (1, 256, 2, 40)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        ref = tattn.flash_attention_ref(q, k, v).float()
        err = (out.float() - ref).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (shape, err)
    for shape, groups, act in [((2, 16, 16, 320), 32, "silu"), ((1, 33, 7, 96), 32, "none"),
                               ((2, 8, 8, 640), 32, "silu")]:
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        w = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
        b = torch.randn(shape[-1], generator=gen, device="cuda")
        before = tnorms.group_norm.launches
        out = tnorms.group_norm(x, w, b, groups, act=act)
        torch.cuda.synchronize()
        assert tnorms.group_norm.launches == before + 1
        ref = tnorms.group_norm_ref(x, w, b, groups, act=act).float()
        err = (out.float() - ref).abs().max().item()
        assert err <= 3e-2 * max(1.0, ref.abs().max().item()), (shape, err)
