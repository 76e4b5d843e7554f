"""The Qwen2-VL slice's kernels in the port, at the shapes this slice gives
them: decode attention (B7, ops.decode_attention.decode_attention) at GQA
group 7 (Qwen2-7B's 28 query heads on 4 KV heads of 128), flash attention
(B1) non-causal with segment ids at head_dim 80 (the vision tower's packed
images, pads in segment 0), RMSNorm (B11) at 3,584 and LayerNorm (B10) at
1,280.

On the CPU: B7's plain version and its split walk at G 7 against the JAX
package's `attention_xla` with its -1e9 bias over the cache (what JAX's
Llama decode runs); `key_splits` at 4 KV heads; the wrappers' acceptance of
G 7 on the bf16 cache alone; B1's plain version with the tower's segment
layouts against JAX's Pallas flash in interpret mode (pad rows attend among
themselves on both sides); the B11 and B10 plans at the new widths. On a
CUDA card only: B7 at G 7 against its plain version per element with a
control, its occupancy, and B11's plan against the library's at 3,584.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` tests also run where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_qwen2_vl_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import norms as tnorms
from paddlemix_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port

FP32_TOL, BF16_ULP = 2e-6, 2.0 ** -7
# B7 at Qwen2-7B's heads: (B, Hq, KVH, D, L, lengths): the image request's
# first and last decode steps (1,230-token prompt, 1,358 slots), a ragged
# pair, the video request's last step (2,426 + 127 keys)
DECODE_CASES = [(1, 28, 4, 128, 1358, (1231,)), (1, 28, 4, 128, 1358, (1357,)),
                (2, 28, 4, 128, 700, (700, 33)), (1, 28, 4, 128, 2554, (2553,))]
# B1's segment layouts at a small size: two images and pads, one image and pads
SEGMENT_LAYOUTS = [(40, 40, 16), (100, 0, 28)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 attention=importlib.import_module("paddlemix_tpu.ops.attention"))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")


def _decode_inputs(seed, b, hq, kvh, d, L):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, 1, hq, d).astype(np.float32)
    k, v = (rs.randn(b, L, kvh, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,hq,kvh,d,L,lengths", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_attention_ref_at_group_7_matches_jax_attention_xla(jx, b, hq, kvh, d, L,
                                                                   lengths, dtype):
    """JAX's Llama decode over the dense cache: attention_xla with a -1e9
    bias past each length, GQA expanded. B7's plain version masks those keys
    to NEG; both weigh them 0 and round P to v's dtype before P V. The
    kernel's walk (`key_splits`' ranges merged) gives the same values."""
    q, k, v = _decode_inputs(0, b, hq, kvh, d, L)
    bias = np.where(np.arange(L)[None, None, None, :] < np.asarray(lengths)[:, None, None, None],
                    0.0, -1e9).astype(np.float32)
    jdt, tdt = (jx.jnp.float32, torch.float32) if dtype == "fp32" else \
        (jx.jnp.bfloat16, torch.bfloat16)
    ref = jx.attention.attention_xla(*(jx.jnp.asarray(t, jdt) for t in (q, k, v)),
                                     bias=jx.jnp.asarray(bias))
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = tda.decode_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), lens)
    assert out.shape == (b, 1, hq, d) and out.dtype == tdt and tda.decode_attention.launches == 0
    ref = np.asarray(ref.astype(jx.jnp.float32))
    got = out.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=FP32_TOL, rtol=1e-5)
    else:  # both round the same fp32 sums once; the sums' order differs
        assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-3 * np.abs(ref).max()).all()
    split = tda.decode_attention_split_ref(*(torch.from_numpy(t) for t in (q, k, v)), lens)
    np.testing.assert_allclose(split.numpy(), ref if dtype == "fp32" else
                               tda.decode_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                                        lens).numpy(), atol=FP32_TOL, rtol=1e-5)


def test_group_7_is_the_bf16_caches_alone_and_key_splits_at_4_kv_heads():
    """B7 takes G 7; B8 (the int8 cache) and B9 (paged) do not. At 4 KV
    heads and batch 1, the key ranges come in multiples of 33 (132 blocks
    an SM multiple), two waves' worth where the cache is long enough."""
    q = torch.zeros(1, 1, 28, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1358, 4, 128, dtype=torch.bfloat16)
    lens = torch.tensor([1231], dtype=torch.int32)
    assert tda._check_decode_args("decode_attention", q, k, k, lens, torch.bfloat16) == \
        (1, 1358, 4, 28, 128)
    with pytest.raises(ValueError, match=r"Hq / KVH in \(1, 2, 4, 8\)"):
        tda._check_decode_args("decode_attention_int8", q, k.to(torch.int8), k.to(torch.int8),
                               lens, torch.int8)
    with pytest.raises(ValueError, match="Hq / KVH"):  # G 6 (Qwen2-VL-2B's) has no kernel
        tda._check_decode_args("decode_attention", q[:, :, :24], k[:, :, :4], k[:, :, :4], lens,
                               torch.bfloat16)
    assert not tpa.paged_decode_supported(28, 4, 128, 16)
    for slots, want in [(1358, (66, 21)), (2554, (132, 20)), (818 + 128, (33, 29)),
                        (64, (4, 16)), (700, (33, 22))]:
        assert tda.key_splits(1, 4, slots) == want, slots
        splits, chunk = want
        assert splits * chunk >= slots and 4 * splits <= 132 * tda.WAVE_BLOCKS_PER_SM
    assert tda.key_splits(2, 4, 700) == (33, 22)


@pytest.mark.parametrize("layout", SEGMENT_LAYOUTS)
def test_flash_ref_with_the_towers_segments_matches_jax_flash_interpret(jx, pallas_interpret,
                                                                        layout):
    """Non-causal attention within segments at head_dim 80, pads in segment 0:
    the plain version against JAX's Pallas flash (interpret mode), whose +1
    shift of the ids keeps its own padding apart but lets segment 0 rows
    attend among themselves, as the port's kernel compares ids as given."""
    a, b2, pads = layout
    s = a + b2 + pads
    seg = np.concatenate([np.full(a, 1), np.full(b2, 2), np.zeros(pads)]).astype(np.int32)[None]
    rs = np.random.RandomState(s)
    q, k, v = (rs.randn(1, s, 2, 80).astype(np.float32) for _ in range(3))
    ref = jx.attention.flash_attention(*(jx.jnp.asarray(t) for t in (q, k, v)),
                                       segment_ids=jx.attention.SegmentIds(
                                           jx.jnp.asarray(seg), jx.jnp.asarray(seg)))
    segs = tattn.SegmentIds(torch.from_numpy(seg), torch.from_numpy(seg))
    out = tattn.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), segment_ids=segs)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * max(1, np.abs(ref).max()), rtol=0)
    # a pad row is the mean of the pads' values under its own softmax: it
    # does not see the images' keys
    alone = tattn.attention_math(*(torch.from_numpy(t[:, s - pads:]) for t in (q, k, v)))
    np.testing.assert_allclose(out[:, s - pads:].numpy(), alone.numpy(), atol=1e-5, rtol=0)
    assert tattn.use_flash((1, 4864, 16, 80), (1, 4864, 16, 80))
    assert tattn.flash_fwd_plan(80) == (128, 80, 128, 3)  # read in place on the D 128 core


def test_norm_plans_at_the_qwen2_vl_widths():
    """B11 at 3,584 (the language model): 448 16-byte chunks, 2 a thread,
    224 threads, one block a row up to 528 rows, then runs of rows; B10 at
    1,280 (the tower): the row form, 160 threads of one chunk."""
    for rows in (1, 1230, 2426):
        plan = tnorms.rms_norm_plan(rows, 3584, 2)
        assert plan.ints()[:3] == (8, 2, 224)
        assert tnorms.layer_norm_plan(rows, 1280, 2).ints() == (tnorms.NORM_ROW, 8, 1, 160, 1,
                                                                rows)
    assert tnorms.rms_norm_plan(1, 3584, 2).ints() == (8, 2, 224, 1, 1)
    x, w = torch.randn(5, 3584), torch.ones(3584)
    np.testing.assert_allclose(tnorms.rms_norm(x, w, 1e-6).numpy(),
                               tnorms.rms_norm_ref(x, w, 1e-6).numpy(), rtol=0, atol=0)
    assert tnorms.rms_norm.launches == 0


# -------------------------------------------------------------- on the card
def _within(out, ref, c):  # chip_smoke.py's per-element gate: 2**-7 |ref| + c |ref|max
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= BF16_ULP * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.gpu
def test_decode_attention_group_7_matches_plain_version_on_gpu():
    """B7 at G 7 per element against the plain version, with every length
    one short a control that must fail; two launches bit-identical; the
    occupancy query answers at G 7 for the bf16 cache and not for the int8
    one, whose wrapper refuses G 7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    for b, hq, kvh, d, L, lengths in DECODE_CASES:
        q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(bf16)
        cache = torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev).to(bf16)
        k, v = cache[0, :, :L], cache[1, :, :L]  # slices of a cache with its parking slot
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        before = tda.decode_attention.launches
        out = tda.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert tda.decode_attention.launches == before + 1
        ref = tda.decode_attention_ref(q.float(), k.float(), v.float(), lens)
        assert _within(out, ref, 4e-3), (b, hq, kvh, d, L, lengths)
        assert not _within(tda.decode_attention(q, k, v, lens - 1), ref, 4e-3)
        assert torch.equal(out, tda.decode_attention(q, k, v, lens))
    assert tda.kernel_blocks_per_sm(128, 7, 0) >= tda.WAVE_BLOCKS_PER_SM
    assert tda.kernel_blocks_per_sm(128, 7, 1) < 0
    k8 = torch.zeros((1, 64, 4, 128), dtype=torch.int8, device=dev)
    s8 = torch.ones((1, 64, 4), device=dev)
    with pytest.raises(ValueError, match="Hq / KVH"):
        tda.decode_attention_int8(torch.zeros((1, 1, 28, 128), dtype=bf16, device=dev), k8, k8,
                                  s8, s8, torch.tensor([4], dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_rms_norm_plan_matches_the_library_at_3584_on_gpu():
    """The library's B11 plan equals the mirror at the language model's rows,
    and the kernel equals its plain version per element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    for rows in (1, 1230, 2426):
        assert tnorms.rms_norm_plan_library(rows, 3584, bf16) == tnorms.rms_norm_plan(rows, 3584,
                                                                                      2)
        x = (3 * torch.randn((rows, 3584), generator=gen, device=dev)).to(bf16)
        w = 1 + 0.1 * torch.randn(3584, generator=gen, device=dev)
        out = tnorms.rms_norm(x, w, 1e-6)
        torch.cuda.synchronize()
        assert _within(out, tnorms.rms_norm_ref(x.float(), w, 1e-6), 1e-6), rows
