"""The flash forward's width table (csrc/flash_fwd.cu: one wgmma core compiled
at 64, 128, 192 and 256) as far as the CPU can hold it:
  - the routing of a caller's head: its compiled width, and whether the
    kernel reads q / k / v in place (a multiple of 8) or padded;
  - `flash_fwd_smem`, the mirror of the kernel's `Smem` layout, at every
    instantiation and form: the bytes a block takes (within the 232,448 a
    block can opt into), its key tile and its ring's depth (chip_smoke.py
    holds the mirror against the library's `flash_fwd_core` on the card);
  - the plain forms the kernels are held against on the card
    (`flash_attention_ref` through `flash_attention`, `flash_fwd_lse_ref`
    through `flash_attention_with_lse`) at heads 80, 160 and 256 with causal +
    segment ids + GQA at a ragged S, against the JAX package's Pallas flash
    kernel in interpret mode on the same seeded inputs.
"""

import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from paddlemix_tpu.ops import attention

    return types.SimpleNamespace(jnp=jnp, attn=attention)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


# ------------------------------------------------------------------- routing
@pytest.mark.parametrize("d", [8, 16, 32, 40, 56, 64, 72, 80, 96, 100, 120, 128, 136, 160,
                               190, 192, 200, 250, 256])
def test_head_routes_to_its_compiled_width(d):
    """A head runs at the least compiled width at or above it; a multiple of
    8 is handed to the kernel as it is (no padding copy: TMA's zero fill
    supplies the columns up to the compiled width), any other head is
    padded with zero columns to the compiled width."""
    plan = tattn.flash_fwd_plan(d)
    assert plan.d_kernel == next(x for x in (64, 128, 192, 256) if x >= d)
    q = torch.randn(1, 3, 2, d)
    (kernel_q,) = tattn._pad_head_dim(plan.width, q)
    if d % 8 == 0:
        assert plan.width == d and kernel_q is q
    else:
        assert plan.width == plan.d_kernel and kernel_q.shape[-1] == plan.d_kernel
        assert torch.equal(kernel_q[..., :d], q) and not kernel_q[..., d:].any()


def test_heads_above_256_are_not_served():
    with pytest.raises(ValueError):
        tattn.flash_fwd_plan(264)


# ------------------------------------------------- the Smem layout's mirror
# (compiled width, int8) -> (keys a tile, ring stages, bytes a block)
_SMEM = {(64, False): (128, 3, 117304), (64, True): (128, 3, 86072),
         (128, False): (128, 3, 231992), (128, True): (128, 3, 167992),
         (192, False): (64, 3, 198456), (192, True): (64, 3, 158264),
         (256, False): (64, 2, 198184), (256, True): (64, 2, 133160)}


@pytest.mark.parametrize("d_kernel,int8", sorted(_SMEM))
def test_smem_mirror(d_kernel, int8):
    """Each instantiation's block fits the 232,448 bytes of shared memory a
    block can opt into, with its key tile and ring depth; the sections the
    swizzle reads (Q, each K and V tile, each 64-column or 128-byte panel of
    them) start on 1,024-byte boundaries."""
    bn, stages, total = _SMEM[(d_kernel, int8)]
    plan = tattn.flash_fwd_plan(d_kernel)
    assert (plan.bn, plan.stages) == (bn, stages)
    assert tattn.flash_fwd_smem(d_kernel, int8) == total <= 232448
    panel = min(d_kernel * (1 if int8 else 2), 128)  # bytes of a q / k row's panel
    # a panel of Q, of a K tile, of a V tile (64 bf16 columns)
    assert all(n % 1024 == 0 for n in (tattn._FWD_BLOCK_M * panel, bn * panel, bn * 128))
    # the registers a consumer thread holds for O, S and P (int8: S's int32
    # copy too) stay below the 240 that setmaxnreg gives it
    assert d_kernel // 2 + bn // 2 + bn // 4 + (bn // 2 if int8 else 0) < 240


# ------------------------------------- the plain forms against JAX's kernel
_MASKED = {"d80": (2, 300, 4, 2, 80), "d160": (2, 300, 4, 2, 160), "d256": (2, 300, 4, 2, 256)}


def _masked_inputs(case):
    """q / k / v with GQA 4 on 2 at S 300 (no multiple of any tile) and three
    segments a row whose cuts lie 11 rows later in row 1 than in row 0."""
    b, s, hq, hkv, d = _MASKED[case]
    rs = np.random.RandomState(d + s)
    q = rs.randn(b, s, hq, d).astype(np.float32)
    k, v = (rs.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    ids = np.zeros((b, s), np.int32)
    for i in range(b):
        for cut in (0.31, 0.58):
            ids[i, int(cut * s) + 11 * i:] += 1
    return q, k, v, ids


@pytest.mark.parametrize("case", sorted(_MASKED))
def test_inference_form_matches_jax_interpret(jx, pallas_interpret, case):
    """flash_attention on the CPU (its plain version) against JAX's Pallas
    flash forward in interpret mode, causal + segment ids + GQA; fp32 both
    sides, so only the order of the sums differs (1e-5 of max(1, |ref|max))."""
    q, k, v, ids = _masked_inputs(case)
    ref = jx.attn.flash_attention(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
                                  segment_ids=jx.attn.SegmentIds(jx.jnp.asarray(ids),
                                                                 jx.jnp.asarray(ids)))
    tids = torch.from_numpy(ids)
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                segment_ids=tattn.SegmentIds(tids, tids), int8_qk=False)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    assert tattn.flash_attention.launches == 0


@pytest.mark.parametrize("case", sorted(_MASKED))
def test_lse_form_matches_jax_interpret(jx, pallas_interpret, case):
    """flash_attention_with_lse on the CPU (the lse form's plain version on q
    pre-scaled as the JAX wrapper scales it) against JAX's
    flash_attention_with_lse in interpret mode, causal + segment ids + GQA:
    o within 1e-5 of max(1, |ref|max), the base-2 lse within 1e-4."""
    q, k, v, ids = _masked_inputs(case)
    ro, rlse = jx.attn.flash_attention_with_lse(
        *(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
        segment_ids=jx.attn.SegmentIds(jx.jnp.asarray(ids), jx.jnp.asarray(ids)))
    tids = torch.from_numpy(ids)
    o, lse = tattn.flash_attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                            causal=True,
                                            segment_ids=tattn.SegmentIds(tids, tids))
    ro, rlse = np.asarray(ro), np.asarray(rlse)
    assert o.shape == ro.shape and lse.shape == rlse.shape
    np.testing.assert_allclose(o.numpy(), ro, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ro).max())))
    np.testing.assert_allclose(lse.numpy(), rlse, rtol=0, atol=1e-4)
    assert tattn.flash_fwd_lse.launches == 0
