"""Port kernels (paddlemix_tpu_torch.ops): plain versions against the JAX
package's Pallas kernels (interpret mode), the flash/math routing rule against
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
# int8-cache prefill, the SFT micro-batch)
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


@pytest.mark.parametrize("option", ["int8_qk"])
def test_unported_flash_options_raise(option):
    """int8 QK^T, an inference-only option, is not ported and raises. The
    options ported since (causal, segment ids, GQA, the lse) are held against
    the JAX kernels in test_torch_train_kernels.py."""
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(q, q, q, **{option: True})


def test_group_norm_rejects_indivisible_channels():
    with pytest.raises(ValueError):
        tnorms.group_norm(torch.zeros(1, 4, 4, 30), torch.ones(30), torch.zeros(30), 32)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(2, 256, 4, 64), (1, 1000, 4, 64), (1, 300, 2, 32), (1, 130, 2, 80)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        before = tattn.flash_attention.launches
        out = tattn.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert tattn.flash_attention.launches == before + 1
        ref = tattn.flash_attention_ref(q, k, v).float()
        err = (out.float() - ref).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (shape, err)
    for shape, groups, act in [((2, 16, 16, 320), 32, "silu"), ((1, 33, 7, 96), 32, "none")]:
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
