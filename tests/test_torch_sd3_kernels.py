"""The SD3 slice's kernels in the port: adaptive LayerNorm (B12,
ops.norms.adaptive_layer_norm) and adaptive LayerNorm fused with the gated
residual (B13, ops.norms.fused_adaln_scale_residual). Their plain versions are
held against the JAX package's Pallas kernels, run in interpret mode (a count
of `pallas_call` shows that the kernel really ran), and against its XLA
references where the JAX package routes there. Also here: the SD3 pieces
around them that have no weights (the 2D sincos position table, T5's
relative position buckets, the FlowMatch scheduler). On a CUDA card only,
each kernel against its plain version.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sd3_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.diffusers.models.embeddings import get_2d_sincos_pos_embed
from paddlemix_tpu_torch.diffusers.schedulers import FlowMatchEulerDiscreteScheduler
from paddlemix_tpu_torch.models.t5 import relative_position_bucket
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    mod = importlib.import_module
    return types.SimpleNamespace(
        jnp=jnp, norms=mod("paddlemix_tpu.ops.norms"),
        emb=mod("paddlemix_tpu.diffusers.models.embeddings"),
        t5=mod("paddlemix_tpu.models.t5.modeling"),
        flow=mod("paddlemix_tpu.diffusers.schedulers.scheduling_flow_match"))


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


def _adaln_inputs(seed, shape):
    rs = np.random.RandomState(seed)
    b, _, h = shape
    return dict(residual=(rs.randn(*shape) * 2 + 0.3).astype(np.float32),
                x=(rs.randn(*shape) * 3 - 0.5).astype(np.float32),
                gate=rs.randn(b, h).astype(np.float32),
                scale=(0.5 * rs.randn(b, h)).astype(np.float32),
                shift=(0.5 * rs.randn(b, h)).astype(np.float32))


# fp32: summation order alone; bf16: the same fp32 math, then one bf16
# rounding of values below 16 (an ulp of 2**-4 at most), which a last-bit
# difference in fp32 can move by one ulp
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


# ------------------------------------------------------------- B12: adaLN
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaptive_layer_norm_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, dtype):
    a = _adaln_inputs(0, (2, 40, 128))  # 80 rows of 128: JAX takes its Pallas kernel
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    j = {k: jx.jnp.asarray(v).astype(dtype) for k, v in a.items()}
    ref = jx.norms.adaptive_layer_norm(j["x"], j["scale"], j["shift"])
    assert len(calls) == 1
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in a.items()}
    out = tnorms.adaptive_layer_norm(t["x"], t["scale"], t["shift"])
    assert out.dtype == getattr(torch, dtype)
    _assert_close(np.asarray(ref.astype("float32")), out, TOL[dtype])
    assert tnorms.adaptive_layer_norm.launches == 0


def test_adaptive_layer_norm_ref_matches_jax_xla(jx):
    """A width that is not a multiple of 128 takes the JAX package's XLA path."""
    a = _adaln_inputs(1, (2, 5, 96))
    ref = jx.norms.adaptive_layer_norm_xla(*(jx.jnp.asarray(a[k]) for k in ("x", "scale", "shift")))
    out = tnorms.adaptive_layer_norm_ref(*(torch.from_numpy(a[k]) for k in ("x", "scale", "shift")))
    _assert_close(ref, out, 1e-6)


# ------------------------------------------- B13: fused adaLN + residual
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adaln_scale_residual_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch,
                                                           dtype):
    a = _adaln_inputs(2, (2, 40, 128))
    names = ("residual", "x", "gate", "scale", "shift")
    calls = _count_pallas_calls(monkeypatch, jx.norms)
    ref_y, ref_resi = jx.norms.fused_adaln_scale_residual(
        *(jx.jnp.asarray(a[k]).astype(dtype) for k in names))
    assert len(calls) == 1
    y, resi = tnorms.fused_adaln_scale_residual(
        *(torch.from_numpy(a[k]).to(getattr(torch, dtype)) for k in names))
    assert y.dtype == resi.dtype == getattr(torch, dtype)
    _assert_close(np.asarray(ref_resi.astype("float32")), resi, TOL[dtype])
    # the norm is taken over the fp32 sum, before it is rounded to `resi`
    _assert_close(np.asarray(ref_y.astype("float32")), y, TOL[dtype])
    assert tnorms.fused_adaln_scale_residual.launches == 0


def test_fused_adaln_scale_residual_ref_matches_jax_xla(jx):
    a = _adaln_inputs(3, (1, 7, 96))
    names = ("residual", "x", "gate", "scale", "shift")
    ref_y, ref_resi = jx.norms.fused_adaln_scale_residual_xla(
        *(jx.jnp.asarray(a[k]) for k in names))
    y, resi = tnorms.fused_adaln_scale_residual_ref(*(torch.from_numpy(a[k]) for k in names))
    _assert_close(ref_resi, resi, 1e-6)
    _assert_close(ref_y, y, 1e-6)


def test_adaln_wrappers_reject_affine_and_other_devices():
    x, m = torch.zeros(1, 2, 64), torch.zeros(1, 64)
    with pytest.raises(NotImplementedError):
        tnorms.adaptive_layer_norm(x, m, m, weight=torch.ones(64))
    with pytest.raises(NotImplementedError):
        tnorms.fused_adaln_scale_residual(x, x, m, m, m, bias=torch.zeros(64))
    xm, mm = x.to("meta"), m.to("meta")
    with pytest.raises(ValueError):
        tnorms.adaptive_layer_norm(xm, mm, mm)
    with pytest.raises(ValueError):
        tnorms.fused_adaln_scale_residual(xm, xm, mm, mm, mm)


# --------------------------------------------- SD3 pieces without weights
@pytest.mark.parametrize("grid", [(8, 8, 8), (6, 4, 16)], ids=["square", "ragged"])
def test_2d_sincos_pos_embed_matches_jax(jx, grid):
    gh, gw, base = grid
    ref = jx.emb.get_2d_sincos_pos_embed(64, gh, gw, base_size=base)
    out = get_2d_sincos_pos_embed(64, gh, gw, base_size=base)
    assert tuple(out.shape) == (gh * gw, 64)
    _assert_close(ref, out, 1e-5)


def test_relative_position_bucket_is_exact(jx):
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]  # every distance up to 299, both signs
    ref = np.asarray(jx.t5.relative_position_bucket(jx.jnp.asarray(rel), 32, 128))
    out = relative_position_bucket(torch.from_numpy(rel), 32, 128)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("steps", [28, 5])
def test_flow_match_scheduler_matches_jax(jx, steps):
    jsched = jx.flow.FlowMatchEulerDiscreteScheduler(shift=3.0)
    sched = FlowMatchEulerDiscreteScheduler(shift=3.0)
    jstate, state = jsched.set_timesteps(steps), sched.set_timesteps(steps)
    assert state.timesteps.dtype == state.sigmas.dtype == torch.float32
    np.testing.assert_array_equal(state.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(state.sigmas.numpy(), np.asarray(jstate.sigmas))
    rs = np.random.RandomState(steps)
    sample, pred = (rs.randn(2, 4, 4, 16).astype(np.float32) for _ in range(2))
    for i in (0, steps - 1):
        ref, _ = jsched.step(jstate, jx.jnp.asarray(pred), i, jx.jnp.asarray(sample))
        out, _ = sched.step(state, torch.from_numpy(pred), i, torch.from_numpy(sample))
        _assert_close(ref, out, 1e-6)


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_adaln_kernels_match_plain_versions_on_gpu():
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

    def within(out, ref):  # one bf16 rounding apart, plus fp32 summation order
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0 ** -7 * ref.abs() + 1e-6 * ref.abs().max()).all())

    # SD3-medium's image and context rows, a width that is not a power of 2,
    # and modulation vectors that are chunks of one (B, 6H) projection
    for b, s, h in [(2, 4096, 1536), (2, 154, 1536), (1, 7, 320)]:
        x, residual = (torch.randn((b, s, h), generator=gen, device=dev).to(bf16) for _ in range(2))
        mod = torch.randn((b, 6 * h), generator=gen, device=dev).to(bf16)
        shift, scale, gate = mod.chunk(6, dim=-1)[:3]
        y = counted(tnorms.adaptive_layer_norm, x, scale, shift)
        assert within(y, tnorms.adaptive_layer_norm_ref(x, scale, shift)), (b, s, h)
        y, resi = counted(tnorms.fused_adaln_scale_residual, residual, x, gate, scale, shift)
        ref_y, ref_resi = tnorms.fused_adaln_scale_residual_ref(residual, x, gate, scale, shift)
        assert within(y, ref_y) and within(resi, ref_resi), (b, s, h)
