"""The InternVL2 and Qwen-VL paths' kernel shapes: B10's forward at 4,096
wide (InternVL2's projector LayerNorm, Qwen-VL's Resampler ln_q / ln_kv /
ln_post), its plain version against the JAX package's Pallas kernel run in
interpret mode (a count of `pallas_call` shows the kernel ran), and its plans
(the row form: two 16-byte chunks a thread at 256 threads in bf16, four in
fp32, sixteen single elements; no plan past 4,096; the backward's limit
stays 2,048). On a CUDA card: B10 at the paths' widths and B1 at InternViT's
(T, 1025, 16, 64), ViT-bigG's (1, 1024, 16, 104) on per-head strided views
and the Resampler's 256 queries over 1,024 keys at 32 x 128, against their
plain versions.

The JAX package is imported through a fixture, so that the `gpu` tests also
run where only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_vlm_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port

# fp32: the sums' order differs (the JAX kernel's blocks), ~1e-7 of the
# values; bf16: both round the same fp32 math once, at most one bf16 step
# (2**-7 |value|) apart
FP32_TOL, BF16_ULP = 2e-6, 2.0 ** -7
VLM_LN_ROWS = [(3328, 4096), (1024, 4096), (256, 4096), (13325, 1024), (1024, 1664)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 norms=importlib.import_module("paddlemix_tpu.ops.norms"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _inputs(seed, rows, h):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, h) * rs.uniform(0.5, 3, (rows, 1)) + rs.randn(rows, 1) * 2
    return [a.astype(np.float32) for a in (x, 1 + 0.2 * rs.randn(h), 0.2 * rs.randn(h))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_at_4096_matches_jax_pallas(jx, pallas_interpret, monkeypatch, dtype):
    """64 rows of 4,096 (JAX takes its kernel): the plain version against the
    Pallas kernel in interpret mode; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    x, w, b = _inputs(29, 64, 4096)
    calls = []
    pallas_call = jx.norms.pl.pallas_call
    monkeypatch.setattr(jx.norms.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    ref = jx.norms.layer_norm(jx.jnp.asarray(x).astype(dtype), jx.jnp.asarray(w),
                              jx.jnp.asarray(b), 1e-6)
    assert len(calls) == 1 and ref.dtype == jx.jnp.dtype(dtype)
    tx = torch.tensor(np.asarray(jx.jnp.asarray(x).astype(dtype).astype(jx.jnp.float32))).to(
        getattr(torch, dtype))
    out = tnorms.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    assert out.dtype == tx.dtype and tnorms.layer_norm.launches == 0
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=FP32_TOL * np.abs(ref).max())
    else:
        assert (np.abs(out - ref) <= BF16_ULP * np.abs(ref) + 1e-6).all()


@pytest.mark.parametrize("rows", [1, 256, 1024, 3328])
def test_layer_norm_plans_at_4096(rows):
    """The row form at every row count: bf16 two 16-byte chunks a thread at
    256 threads, fp32 four, the one-element form sixteen; a block a row. No
    plan past 4,096; the backward none past 2,048."""
    assert tnorms.layer_norm_plan(rows, 4096, 2).ints() == (tnorms.NORM_ROW, 8, 2, 256, 1, rows)
    assert tnorms.layer_norm_plan(rows, 4096, 4).ints() == (tnorms.NORM_ROW, 4, 4, 256, 1, rows)
    assert tnorms.layer_norm_plan(rows, 4096, 2, aligned=False).ints() == \
        (tnorms.NORM_ROW, 1, 16, 256, 1, rows)
    assert tnorms.layer_norm_plan(rows, 3000, 2).ints() == (tnorms.NORM_ROW, 8, 2, 192, 1, rows)
    assert tnorms.layer_norm_plan(rows, 4097, 2) is None
    assert tnorms.layer_norm_bwd_plan(rows, 4096, 2) is None
    x = torch.zeros(rows, 4096, dtype=torch.bfloat16)
    tnorms._ln_check("layer_norm", x, (torch.ones(4096), torch.zeros(4096)),
                     tnorms._LN_FWD_MAX_WIDTH)
    with pytest.raises(ValueError, match="at most 2048 wide"):
        tnorms._layer_norm_bwd_cuda(x, torch.ones(4096), x, 1e-6)


def test_paths_route_to_flash_at_their_shapes():
    """InternViT's 1,025 tokens, ViT-bigG's 1,024 (head 104, a multiple of 8:
    read in place on the D 128 core) and the Resampler's 256 queries over
    1,024 keys go to B1."""
    for q, k in (((13, 1025, 16, 64),) * 2, ((1, 1024, 16, 104),) * 2,
                 ((2, 256, 32, 128), (2, 1024, 32, 128))):
        assert tattn.use_flash(q, k)
    plan = tattn.flash_fwd_plan(104)
    assert (plan.d_kernel, plan.width) == (128, 104)  # the D 128 core, the head read in place


# ------------------------------------------------------------- on the card
def _gate(out, ref, c):  # chip_smoke.py's per-element gate: 2**-7 |ref| + c |ref|max
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.gpu
def test_layer_norm_at_the_vlm_rows_on_gpu():
    """B10 at the paths' rows (4,096 wide: the projector's 13 tiles x 256, the
    Resampler's 1,024 and 256; the towers' 1,024 and 1,664) per element
    against the plain version; the plan the library's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for rows, h in VLM_LN_ROWS:
        x = (2 * torch.randn((rows, h), generator=gen, device="cuda")
             + torch.randn((rows, 1), generator=gen, device="cuda")).to(torch.bfloat16)
        w = 1 + 0.2 * torch.randn(h, generator=gen, device="cuda")
        b = 0.2 * torch.randn(h, generator=gen, device="cuda")
        assert tnorms.layer_norm_plan(rows, h, 2) == \
            tnorms.layer_norm_plan_library(rows, h, torch.bfloat16)
        y = tnorms.layer_norm(x, w, b, 1e-6)
        assert _gate(y, tnorms.layer_norm_ref(x.float(), w, b, 1e-6), 1e-6), (rows, h)


@pytest.mark.gpu
def test_flash_at_the_vlm_shapes_on_gpu():
    """B1 at InternViT's (13, 1025, 16, 64) on global-thirds views, ViT-bigG's
    (1, 1024, 16, 104) on per-head views (read in place) and the Resampler's
    (1, 256 / 1024, 32, 128), per element (c 4e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    qkv = torch.randn((13, 1025, 3, 16, 64), generator=gen, device=dev).to(bf16)
    cases = [qkv.unbind(2)]
    qkv = torch.randn((1, 1024, 16, 312), generator=gen, device=dev).to(bf16)
    cases.append(qkv.chunk(3, dim=-1))
    cases.append(tuple(torch.randn(shape, generator=gen, device=dev).to(bf16)
                       for shape in ((1, 256, 32, 128), (1, 1024, 32, 128), (1, 1024, 32, 128))))
    for q, k, v in cases:
        out = tattn.flash_attention(q, k, v, int8_qk=False)
        assert _gate(out, tattn.flash_attention_ref(q.float(), k.float(), v.float()), 4e-3)
