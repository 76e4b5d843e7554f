"""B1's int8 QK^T form on the forward's wgmma core and the decode attention
kernels B7 / B8 as the port runs them on Hopper, held where the CPU can hold
them:
  - the forward's fixed width table with the int8 form (`flash_fwd_plan`);
  - `quantize_qk_int8`, the wrapper of the activation pass that runs before
    the wgmma core (on the CPU its plain version, `int8_qk_operands`),
    against the operands JAX's int8 prologue hands its pallas_call, bit for
    bit, at the options the wgmma core now serves (GQA, ragged S, D 64 / 128);
  - the int8 form's plain version against JAX's int8 flash in interpret mode
    at those options (causal, segment ids, GQA, ragged S);
  - `key_splits`, the decode kernels' grid: whole waves of the card at the
    serving shapes, ranges that cover the cache;
  - `decode_attention_split_ref`, the kernels' split-then-merge walk, against
    the plain versions and JAX's Pallas decode kernel in interpret mode.
On a CUDA card only, the kernels against these, in one gpu test. Inputs are
made with numpy from a seed. The JAX package is imported through a fixture,
so that the `gpu` test also runs where only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_int8_attention_decode.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.models.llama.modeling import _quantize_kv
from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import decode_attention as tda

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    mod = importlib.import_module
    return types.SimpleNamespace(jnp=jnp, attn=mod("paddlemix_tpu.ops.attention"),
                                 da=mod("paddlemix_tpu.ops.decode_attention"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _excess(out, ref, c):
    """max of |out - ref| - 2**-7 |ref| - c |ref|max: chip_smoke.py's gate of
    a bf16 result against an fp32 plain version (must be <= 0)."""
    ref = ref.float()
    diff = (out.float() - ref).abs() - 2.0 ** -7 * ref.abs()
    return (diff - c * ref.abs().max()).max().item()


# ----------------------------------------------------- the forward's core table
# the caller's head -> (compiled width, the width the kernel reads): a multiple
# of 8 is read in place, any other head padded to the compiled width
_ROUTES = {32: (64, 32), 40: (64, 40), 64: (64, 64), 80: (128, 80), 96: (128, 96),
           100: (128, 128), 128: (128, 128), 160: (192, 160), 200: (256, 200), 256: (256, 256)}


@pytest.mark.parametrize("d", sorted(_ROUTES))
def test_fwd_core_table(d):
    """csrc/flash_fwd.cu's fixed table: one core at the compiled widths 64,
    128, 192 and 256, a head at the least at or above it (SD1.5's 40 at 64,
    80 at 128, 160 at 192), 128-key tiles in 3 stages up to 128, 64-key
    tiles in 3 stages at 192 and 2 at 256."""
    plan = tattn.flash_fwd_plan(d)
    assert (plan.d_kernel, plan.width) == _ROUTES[d]
    assert (plan.bn, plan.stages) == {64: (128, 3), 128: (128, 3), 192: (64, 3),
                                      256: (64, 2)}[plan.d_kernel]


@pytest.mark.parametrize("d", sorted(_ROUTES))
def test_int8_heads_route_by_compiled_width(d):
    """The int8 form routes as the bf16 form does: its activation pass reads
    the head at the plan's width and writes q8 / k8 at the compiled width,
    which the core's int8 instantiation reads; its block fits the card and
    takes less shared memory than the bf16 form's (int8 q / k tiles)."""
    plan = tattn.flash_fwd_plan(d)
    assert plan.d_kernel == _ROUTES[d][0]
    assert tattn.flash_fwd_smem(plan.d_kernel, True) < tattn.flash_fwd_smem(plan.d_kernel, False)
    assert tattn.flash_fwd_smem(plan.d_kernel, False) <= 232448


# ------------------------------------------------ int8 operands and the plain form
# (B, S, Hq, Hkv, D, causal, segments): the wgmma core's options at a ragged S
_WG_CASES = {
    "gqa_ragged_d64": (1, 200, 4, 2, 64, False, False),
    "causal_segments_gqa_d64": (2, 200, 4, 2, 64, True, True),
    "segments_gqa_d128": (1, 300, 4, 2, 128, False, True),
    "causal_d128": (1, 256, 2, 2, 128, True, False),
}


def _wg_inputs(case):
    b, s, hq, hkv, d, causal, segments = _WG_CASES[case]
    rs = np.random.RandomState(s + d)
    q = rs.randn(b, s, hq, d).astype(np.float32)
    k, v = (rs.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    seg = None
    if segments:  # three segments a row, cut off the 128-row tiles, row i 11 i later
        ids = np.zeros((b, s), np.int32)
        for i in range(b):
            for cut in (0.31, 0.58):
                ids[i, int(cut * s) + 11 * i:] += 1
        seg = (ids, ids)
    return q, k, v, causal, seg


def _jax_int8(jx, monkeypatch, q, k, v, causal, seg):
    """JAX's int8 flash in interpret mode, and the inputs its XLA prologue
    hands the pallas_call (q8, k8, v, sq, sk, ...)."""
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


@pytest.mark.parametrize("case", sorted(_WG_CASES))
def test_quantize_qk_int8_matches_jax_prologue(jx, pallas_interpret, monkeypatch, case):
    """The pass's wrapper gives JAX's quantized rows and row scales bit for bit
    (JAX's arrays are (B, H, S, D), their rows padded to a whole tile)."""
    q, k, v, causal, seg = _wg_inputs(case)
    q8j, k8j, _, sqj, skj = _jax_int8(jx, monkeypatch, q, k, v, causal, seg)[1][:5]
    b, s, hq, d = q.shape
    q8, k8, sq, sk = tattn.quantize_qk_int8(torch.from_numpy(q), torch.from_numpy(k), d ** -0.5)
    assert q8.dtype == k8.dtype == torch.int8 and sq.dtype == sk.dtype == torch.float32
    assert sq.shape == (b, s, hq) and sk.shape == (b, s, k.shape[2])
    np.testing.assert_array_equal(q8.permute(0, 2, 1, 3).numpy(), q8j[:, :, :s, :d])
    np.testing.assert_array_equal(k8.permute(0, 2, 1, 3).numpy(), k8j[:, :, :s, :d])
    np.testing.assert_array_equal(sq.permute(0, 2, 1).numpy(), sqj[:, :, :s, 0])
    np.testing.assert_array_equal(sk.permute(0, 2, 1).numpy(), skj[:, :, 0, :s])


@pytest.mark.parametrize("case", sorted(_WG_CASES))
def test_int8_form_matches_jax_interpret(jx, pallas_interpret, monkeypatch, case):
    """flash_attention_int8 on the CPU (the plain version) against JAX's int8
    kernel in interpret mode at the wgmma core's options: the same int8
    scores, fp32 on both sides, so only summation order differs (1e-5 of
    |ref|max)."""
    q, k, v, causal, seg = _wg_inputs(case)
    ref, _ = _jax_int8(jx, monkeypatch, q, k, v, causal, seg)
    tseg = None if seg is None else tattn.SegmentIds(*(torch.from_numpy(s) for s in seg))
    out = tattn.flash_attention_int8(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                     segment_ids=tseg)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    assert tattn.flash_attention_int8.launches == 0


# ------------------------------------------------------------ the decode grid
# (batch, kv heads, slots, blocks an SM): the Llama-2-7B request's last decode
# step (B8 and B7), LLaVA's 736-slot cache (B7), chip_smoke.py's GQA cache
_SERVING = [(1, 32, 4096, 8), (1, 32, 736, 8), (2, 8, 4096, 4)]


@pytest.mark.parametrize("batch,kvh,slots,per_sm", _SERVING,
                         ids=["llama-4096", "llava-736", "gqa-4096"])
def test_key_splits_fill_whole_waves_at_serving_shapes(batch, kvh, slots, per_sm):
    """At the serving shapes the grid is a whole number of waves of
    WAVE_BLOCKS_PER_SM blocks an SM on 132 SMs (the same number of blocks on
    every SM, all of them resident at once on an H100), and its ranges, the
    least equal ones that cover the cache, hold at least _MIN_SPLIT_KEYS
    keys (a range past the last slot holds none: its block writes m = -inf)."""
    splits, chunk = tda.key_splits(batch, kvh, slots)
    blocks = batch * kvh * splits
    assert blocks == 132 * per_sm and per_sm % tda.WAVE_BLOCKS_PER_SM == 0
    assert chunk == -(-slots // splits) >= tda._MIN_SPLIT_KEYS


@pytest.mark.parametrize("batch,kvh,slots", [
    (1, 32, 4096), (2, 32, 4096), (8, 32, 2127), (1, 8, 4096), (1, 1, 4096), (3, 5, 1000),
    (1, 32, 100), (1, 32, 16), (4, 8, 64),
])
def test_key_splits_cover_the_cache(batch, kvh, slots):
    """Any shape: the least equal ranges that cover the slots, and where a
    multiple of 132 blocks is possible with ranges of at least
    _MIN_SPLIT_KEYS, the grid is one; otherwise it stays within one wave."""
    splits, chunk = tda.key_splits(batch, kvh, slots)
    blocks = batch * kvh * splits
    assert splits >= 1 and chunk == -(-slots // splits)
    unit = 132 // np.gcd(batch * kvh, 132)
    if unit <= slots // tda._MIN_SPLIT_KEYS:
        assert blocks % 132 == 0
    else:
        assert blocks <= max(batch * kvh, 132 * tda.WAVE_BLOCKS_PER_SM)


# ------------------------------------------------- the split-then-merge walk
def _int8_cache(rs, b, L, kvh, g, d, lengths):
    q = rs.randn(b, 1, kvh * g, d).astype(np.float32)
    k = rs.randn(b, L, kvh, d).astype(np.float32)
    v = rs.randn(b, L, kvh, d).astype(np.float32)
    for i, n in enumerate(lengths):  # garbage past each length, large enough to show
        k[i, n:] *= 30.0
        v[i, n:] = 1e3
    kq, ks = _quantize_kv(torch.from_numpy(k))
    vq, vs = _quantize_kv(torch.from_numpy(v))
    return (torch.from_numpy(q), kq, vq, ks, vs, torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("splits", [None, 1, 3, 33])
@pytest.mark.parametrize("b,L,kvh,g,d,lengths", [
    (3, 256, 2, 2, 64, [200, 0, 256]),
    (2, 384, 8, 4, 128, [300, 129]),
], ids=["gqa2-d64", "gqa4-d128"])
def test_int8_split_walk_matches_plain_and_jax(jx, pallas_interpret, b, L, kvh, g, d, lengths,
                                               splits):
    """B8's walk (key ranges, then the merge), P and V in fp32, against its
    plain version (summation order alone: 1e-5 of |ref|max) and JAX's Pallas
    kernel in interpret mode (the JAX tests' 2e-3 / 1e-2); a length of 0
    gives zeros, and the garbage past each length is not seen."""
    q, kq, vq, ks, vs, lens = _int8_cache(np.random.RandomState(L + d), b, L, kvh, g, d, lengths)
    out = tda.decode_attention_split_ref(q, kq, vq, lens, k_scale=ks, v_scale=vs, splits=splits)
    ref = tda.decode_attention_int8_ref(q, kq, vq, ks, vs, lens)
    assert out.shape == (b, 1, kvh * g, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    jref = jx.da.decode_attention_int8(*(jx.jnp.asarray(t.numpy()) for t in
                                         (q, kq, vq, ks, vs, lens)), block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref, np.float32), atol=2e-3, rtol=1e-2)
    assert not out[np.asarray(lengths) == 0].any()
    assert out.abs().max() < 10


@pytest.mark.parametrize("splits", [None, 1, 5])
def test_bf16_split_walk_matches_plain_and_jax(jx, pallas_interpret, splits):
    """B7's walk, P rounded to bf16 for P V, against its plain version (P
    rounded after the softmax) and JAX's Pallas kernel in interpret mode,
    within chip_smoke.py's B7 gate: 2**-7 |ref| + 4e-3 |ref|max."""
    rs = np.random.RandomState(5)
    b, L, kvh, g, d, lengths = 2, 384, 4, 2, 128, [300, 17]
    q = torch.from_numpy(rs.randn(b, 1, kvh * g, d).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(b, L, kvh, d).astype(np.float32)).bfloat16()
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = tda.decode_attention_split_ref(q, k, v, lens, splits=splits)
    ref = tda.decode_attention_ref(q, k, v, lens)
    assert _excess(out, ref, 4e-3) <= 0
    jref = jx.da.decode_attention(*(jx.jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                  jx.jnp.asarray(lens.numpy()), block_k=128)
    assert _excess(out, torch.tensor(np.asarray(jref, np.float32)), 4e-3) <= 0


# ------------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_kernels_match_mirrors_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    # the activation pass bit for bit, and B1's int8 form on the wgmma core
    for (b, s, hq, hkv, d, causal, segments) in _WG_CASES.values():
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda", dtype=bf16)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda", dtype=bf16)
                for _ in range(2))
        got = tattn.quantize_qk_int8(q, k, d ** -0.5)
        want = tattn.int8_qk_operands(q, k, d ** -0.5)
        assert all(bool((a == w).all()) for a, w in zip(got, want)), (s, d)
        seg = None
        if segments:
            ids = (torch.arange(s, device="cuda")[None] >= torch.tensor(
                [[int(0.31 * s) + 11 * i] for i in range(b)], device="cuda")).int()
            seg = tattn.SegmentIds(ids, ids)
        before = tattn.flash_attention_int8.launches
        out = tattn.flash_attention_int8(q, k, v, causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        assert tattn.flash_attention_int8.launches == before + 1
        ref = tattn.flash_attention_int8_ref(q, k, v, causal=causal, segment_ids=seg)
        assert _excess(out, ref, 4e-3) <= 0, (s, d)
    # B8 and B7 against the walk they share with the mirror, and the plain versions
    for b, L, kvh, g, d, lengths in [(1, 4096, 32, 1, 128, [4095]), (2, 1000, 8, 4, 64, [999, 0]),
                                     (1, 736, 32, 1, 128, [609])]:
        q = torch.randn((b, 1, kvh * g, d), generator=gen, device="cuda").to(bf16)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kq, ks = _quantize_kv(torch.randn((b, L, kvh, d), generator=gen, device="cuda"))
        vq, vs = _quantize_kv(torch.randn((b, L, kvh, d), generator=gen, device="cuda"))
        out = tda.decode_attention_int8(q, kq, vq, ks, vs, lens)
        ref = tda.decode_attention_split_ref(q.float(), kq, vq, lens, k_scale=ks, v_scale=vs)
        assert _excess(out, ref, 1e-5) <= 0, (L, g)
        assert not out[lens == 0].any()
        k, v = (torch.randn((b, L, kvh, d), generator=gen, device="cuda").to(bf16)
                for _ in range(2))
        lens = lens.clamp(min=1)  # the bf16 plain version reads a length of 0 as all keys
        out = tda.decode_attention(q, k, v, lens)
        assert _excess(out, tda.decode_attention_ref(q.float(), k.float(), v.float(), lens),
                       4e-3) <= 0, (L, g)
        assert tda.kernel_blocks_per_sm(d, g, True) >= tda.WAVE_BLOCKS_PER_SM
