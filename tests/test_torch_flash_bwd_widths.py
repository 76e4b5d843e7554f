"""The flash backward's width table (csrc/flash_bwd.cu: one wgmma core
compiled at 64, 128, 192 and 256, the forward's widths) as far as the CPU can
hold it:
  - the routing of a caller's head: its compiled width, and whether the
    kernels read q / k / v / do in place (a multiple of 8) or padded;
  - `flash_bwd_smem`, the mirror of the kernels' `BwdSmem` layout, at every
    width and kernel: the bytes a block takes (within the 232,448 a block
    can opt into), its owned rows, walked tile and ring depth, and whether
    its warpgroups split the outputs (chip_smoke.py holds the mirror against
    the library's `flash_bwd_core` on the card);
  - the plain versions the kernels are held against on the card
    (`flash_bwd_dkv_ref` / `flash_bwd_dq_ref` and their tiled walks) at heads
    24, 32 and 256 with causal + segment ids + GQA at a ragged S, against the
    JAX package's `_flash_bwd` in Pallas interpret mode (through `jax.vjp` of
    its `flash_attention`) on the same seeded inputs.
"""

import functools
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.torch_port

# fp32 on both sides: the two differ by summation order only (JAX's blocked
# kernels against the plain versions' whole rows, or their 64 x 64 tiles), as
# a fraction of max(1, |ref|max)
BWD_TOL = 5e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from paddlemix_tpu.ops import attention

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, attn=attention)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


# ------------------------------------------------------------------- routing
@pytest.mark.parametrize("d", [8, 16, 20, 24, 32, 40, 56, 64, 80, 100, 128, 136, 160, 192, 200,
                               256])
def test_head_routes_to_its_compiled_width(d):
    """A head runs at the least compiled width at or above it, the forward's
    (heads of 32 or less at 64, 160 at 192, 200 at 256); a multiple of 8 is
    handed to the kernels as it is (TMA's zero fill supplies the columns up
    to the compiled width), any other head is padded with zero columns to
    the compiled width."""
    plan = tattn.flash_bwd_plan(d)
    assert plan.d_kernel == next(x for x in (64, 128, 192, 256) if x >= d)
    assert plan.d_kernel == tattn.flash_fwd_plan(d).d_kernel
    assert plan.width == tattn.flash_fwd_plan(d).width
    q = torch.randn(1, 3, 2, d)
    (kernel_q,) = tattn._pad_head_dim(plan.width, q)
    if d % 8 == 0:
        assert plan.width == d and kernel_q is q
    else:
        assert plan.width == plan.d_kernel and kernel_q.shape[-1] == plan.d_kernel
        assert torch.equal(kernel_q[..., :d], q) and not kernel_q[..., d:].any()


@pytest.mark.parametrize("d", [0, 264, 512])
def test_heads_outside_the_table_are_refused(d):
    with pytest.raises(ValueError):
        tattn.flash_bwd_plan(d)


# --------------------------------------------- the BwdSmem layout's mirror
# (compiled width, dK/dV kernel) -> (rows a block owns, stages, split, bytes a block)
_SMEM = {(64, True): (128, 4, False, 102536), (64, False): (128, 4, False, 102536),
         (128, True): (128, 4, False, 200840), (128, False): (128, 4, False, 200840),
         (192, True): (64, 3, True, 216424), (192, False): (128, 2, False, 199240),
         (256, True): (64, 2, True, 215624), (256, False): (64, 2, True, 232008)}


@pytest.mark.parametrize("d_kernel,dkv", sorted(_SMEM))
def test_smem_mirror(d_kernel, dkv):
    """Each kernel's block at each width fits the 232,448 bytes of shared
    memory a block can opt into, with its owned rows, 64-row walked tiles and
    ring depth; the sections the swizzle reads (each owned operand, each
    walked tile, each 64-column panel of them) start on 1,024-byte
    boundaries; and the accumulators a consumer thread holds stay below the
    232 registers that setmaxnreg gives it."""
    own, stages, split, total = _SMEM[(d_kernel, dkv)]
    plan = tattn.flash_bwd_plan(d_kernel)
    form = plan.dkv if dkv else plan.dq
    assert plan.walk == tattn.BWD_TILE == 64
    assert form == (own, stages, split)
    assert tattn.flash_bwd_smem(d_kernel, dkv) == total <= 232448
    assert all(n % 1024 == 0 for n in (own * 128, plan.walk * 128))
    # fp32 registers a thread: by rows, the sums (dK and dV, or dQ: D / 2
    # each), S and dP (32 each) and their bf16 A fragments (16 each); by
    # output, one sum (dK or dV, or half of dQ), one score tile and its
    # fragment
    if not split:
        regs = (2 if dkv else 1) * d_kernel // 2 + 32 + 32 + 16 * (2 if dkv else 1)
    else:
        regs = (d_kernel // 2 if dkv else d_kernel // 4) + 32 + 16
    assert regs < 232


# ------------------------------------- the plain versions against JAX's kernel
_MASKED = {"d24": (2, 300, 4, 2, 24), "d32": (2, 300, 4, 2, 32), "d256": (2, 300, 4, 2, 256)}


def _masked_inputs(case):
    """q / k / v / do with GQA 4 on 2 at S 300 (no multiple of any tile) and
    three segments a row whose cuts lie 11 rows later in row 1 than in row 0."""
    b, s, hq, hkv, d = _MASKED[case]
    rs = np.random.RandomState(d + s + 1)
    q, do = (rs.randn(b, s, hq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    ids = np.zeros((b, s), np.int32)
    for i in range(b):
        for cut in (0.31, 0.58):
            ids[i, int(cut * s) + 11 * i:] += 1
    return q, k, v, do, ids


@pytest.fixture(scope="module")
def jax_grads(jx):
    """case -> JAX's (dq, dk, dv) of it, each case computed once."""
    return functools.lru_cache(maxsize=None)(functools.partial(_jax_grads, jx))


def _jax_grads(jx, case):
    """JAX's dq, dk, dv through the custom_vjp of its flash_attention (causal
    + segment ids), as float32 numpy; asserts that the lse forward and the
    two backward kernels ran."""
    q, k, v, do, ids = _masked_inputs(case)
    calls = []
    pallas_call = jx.attn.pl.pallas_call
    jx.attn.pl.pallas_call = lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw)
    try:
        segs = jx.attn.SegmentIds(jx.jnp.asarray(ids), jx.jnp.asarray(ids))
        _, vjp = jx.jax.vjp(lambda *t: jx.attn.flash_attention(*t, causal=True, segment_ids=segs),
                            *(jx.jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jx.jnp.asarray(do))
    finally:
        jx.attn.pl.pallas_call = pallas_call
    assert len(calls) == 3
    return tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled"])
@pytest.mark.parametrize("case", sorted(_MASKED))
def test_backward_refs_match_jax_interpret(jax_grads, pallas_interpret, case, tiled):
    """flash_bwd_dkv_ref / flash_bwd_dq_ref (or the tiled walks, which skip
    the pairs the kernels skip) from the port's lse form (qs, the base-2 lse,
    di = rowsum(o * do)) against JAX's dq, dk, dv, causal + segment ids + GQA,
    fp32 both sides (BWD_TOL of max(1, |ref|max)); no kernel launches."""
    q, k, v, do, ids = _masked_inputs(case)
    jdq, jdk, jdv = jax_grads(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tids = torch.from_numpy(ids)
    kw = dict(causal=True, segment_ids=tattn.SegmentIds(tids, tids))
    scale = q.shape[3] ** -0.5
    qs = tq * (scale * tattn.LOG2E)
    o, lse = tattn.flash_fwd_lse_ref(qs, tk, tv, **kw)
    di = (o * tdo).sum(-1).transpose(1, 2).contiguous()
    if tiled:
        dk, dv = tattn.flash_bwd_dkv_tiled_ref(qs, tk, tv, tdo, lse, di, **kw)
        dq = tattn.flash_bwd_dq_tiled_ref(qs, tk, tv, tdo, lse, di, scale=scale, **kw)
    else:
        dk, dv = tattn.flash_bwd_dkv_ref(qs, tk, tv, tdo, lse, di, **kw)
        dq = tattn.flash_bwd_dq_ref(qs, tk, tv, tdo, lse, di, scale=scale, **kw)
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=BWD_TOL * max(1.0, float(np.abs(ref).max())))
    assert tattn.flash_bwd_dkv.launches == 0 and tattn.flash_bwd_dq.launches == 0
