"""The Llama serving slice's kernels in the port: decode attention over the
int8 KV cache (B8, ops.decode_attention.decode_attention_int8) and over the
paged KV pool (B9, ops.paged_attention.paged_decode_attention), with the
int8 cache's quantizer. Their plain versions are held against the JAX
package's Pallas kernels, run in interpret mode (a count of `pallas_call`
shows that the kernel really ran), and B8's also against the JAX XLA
reference on the dequantized cache; the quantizer is held bit-exact. On a
CUDA card only, each kernel against its plain version, and the wrappers
raising at shapes the kernels do not take.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package is imported through a fixture, so that the `gpu` test also runs where
only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_llama_kv_kernels.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from paddlemix_tpu_torch.models.llama.modeling import _quantize_kv
from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port

# the JAX package's own tolerance for its int8 decode kernel (tests/test_ops.py)
ATOL, RTOL = 2e-3, 1e-2


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    mod = importlib.import_module
    return types.SimpleNamespace(jnp=jnp, da=mod("paddlemix_tpu.ops.decode_attention"),
                                 pa=mod("paddlemix_tpu.ops.paged_attention"),
                                 llama=mod("paddlemix_tpu.models.llama.modeling"))


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


def _close(ref, out):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


# --------------------------------------------------- the int8 cache quantizer
def test_quantize_kv_is_bit_exact(jx):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 5, 3, 64) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0                       # all zeros: the 1e-8 floor
    x[0, 1, 0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[0, 1, 0, 8:] = 0.0                   # scale 1.0: exact .5 ties, half to even
    # scale 3.0: 4.5 / 3 and -7.5 / 3 are ties; the float below 28.5 over 3
    # rounds to 9, but times fl(1 / 3) to 9.5 and then 10
    x[0, 2, 0, :4] = [381, np.nextafter(np.float32(28.5), np.float32(0)), 4.5, -7.5]
    x[0, 2, 0, 4:] = 1.0
    jq, js = jx.llama._quantize_kv(jx.jnp.asarray(x))
    q, s = _quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (2, 5, 3)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0].item() == np.float32(1e-8) and (q[0, 0, 0] == 0).all()
    assert q[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert s[0, 2, 0].item() == 3.0 and q[0, 2, 0, :4].tolist() == [127, 9, 2, -2]
    # the card's inputs are bf16: quantized from their fp32 values, the same in both
    xb = torch.from_numpy(x).bfloat16()
    jq, js = jx.llama._quantize_kv(jx.jnp.asarray(xb.float().numpy()).astype(jx.jnp.bfloat16))
    q, s = _quantize_kv(xb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ------------------------------------------------ B8: int8-cache decode attention
def _int8_inputs(rs, b, L, kvh, g, d, lengths):
    q = rs.randn(b, 1, kvh * g, d).astype(np.float32)
    k = rs.randn(b, L, kvh, d).astype(np.float32)
    v = rs.randn(b, L, kvh, d).astype(np.float32)
    for i, n in enumerate(lengths):  # garbage past each length, large enough to show
        k[i, n:] *= 30.0
        v[i, n:] = 1e3
    kq, ks = _quantize_kv(torch.from_numpy(k))
    vq, vs = _quantize_kv(torch.from_numpy(v))
    return q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,L,hq,kvh,d,lengths", [
    (3, 256, 4, 2, 64, [200, 0, 256]),
    (2, 384, 32, 8, 128, [300, 129]),
    (2, 256, 4, 2, 128, [1, 77]),
], ids=["gqa4:2-d64", "gqa32:8-d128", "gqa4:2-d128"])
def test_decode_attention_int8_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, b, L,
                                                      hq, kvh, d, lengths):
    rs = np.random.RandomState(L + d)
    args = _int8_inputs(rs, b, L, kvh, hq // kvh, d, lengths)
    calls = _count_pallas_calls(monkeypatch, jx.da)
    # 128-key blocks: a partial last block, and blocks wholly past a length
    ref = jx.da.decode_attention_int8(*(jx.jnp.asarray(a) for a in args), block_k=128)
    assert len(calls) == 1  # the Pallas kernel ran, interpreted
    out = tda.decode_attention_int8(*(torch.from_numpy(a) for a in args))
    assert out.shape == (b, 1, hq, d) and out.dtype == torch.float32
    _close(ref, out)
    assert np.abs(np.asarray(ref)).max() < 10  # the garbage (v = 1e3) was masked
    zero = np.asarray(lengths) == 0
    assert (out[torch.from_numpy(zero)] == 0).all()  # a length of 0 gives zeros, as the kernel
    assert tda.decode_attention_int8.launches == 0


def test_decode_attention_int8_ref_matches_jax_xla_on_dequantized_cache(jx):
    rs = np.random.RandomState(9)
    q, kq, vq, ks, vs, lengths = _int8_inputs(rs, 2, 96, 2, 4, 64, [96, 33])
    kd = kq.astype(np.float32) * ks[..., None]
    vd = vq.astype(np.float32) * vs[..., None]
    ref = jx.da.decode_attention_xla(*(jx.jnp.asarray(a) for a in (q, kd, vd, lengths)))
    t = torch.from_numpy
    out = tda.decode_attention_int8_ref(t(q), t(kq), t(vq), t(ks), t(vs), t(lengths))
    _close(ref, out)


# ------------------------------------------------------- B9: paged decode attention
def _paged_inputs(rs, h, kvh, d, bs, tables, lengths, pool_blocks):
    q = rs.randn(len(lengths), h, d).astype(np.float32)
    k_pool = rs.randn(pool_blocks, kvh, bs, d).astype(np.float32)
    v_pool = rs.randn(pool_blocks, kvh, bs, d).astype(np.float32)
    return q, k_pool, v_pool, np.asarray(tables, np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("h,kvh,d,bs", [(8, 2, 128, 128), (4, 4, 128, 128), (8, 4, 64, 16)],
                         ids=["gqa8:2", "mha", "d64-bs16"])
def test_paged_decode_attention_ref_matches_jax_pallas(jx, pallas_interpret, monkeypatch, h, kvh,
                                                       d, bs):
    rs = np.random.RandomState(h + d + bs)
    # a fragmented pool (unordered ids), -1 entries, lengths mid-block (2.37
    # blocks, 0.62), on a block edge (2 blocks) and of one key
    tables = [[6, 1, 4], [3, -1, -1], [0, 5, -1], [7, -1, -1]]
    lengths = [2 * bs + 3 * bs // 8 - 1, 5 * bs // 8, 2 * bs, 1]
    args = _paged_inputs(rs, h, kvh, d, bs, tables, lengths, 8)
    calls = _count_pallas_calls(monkeypatch, jx.pa)
    ref = jx.pa.paged_decode_attention(*(jx.jnp.asarray(a) for a in args))
    assert len(calls) == 1
    out = tpa.paged_decode_attention(*(torch.from_numpy(a) for a in args))
    assert out.shape == (4, h, d)
    _close(ref, out)
    assert tpa.paged_decode_attention.launches == 0


def test_paged_decode_attention_ref_is_a_gather_then_attention():
    """The plain version against dense attention over each sequence's
    gathered keys, in float64."""
    rs = np.random.RandomState(3)
    h, kvh, d, bs = 4, 2, 64, 16
    q, kp, vp, tables, lengths = _paged_inputs(rs, h, kvh, d, bs, [[2, 0], [1, -1]], [20, 16], 3)
    out = tpa.paged_decode_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tables,
                                                                          lengths)))
    for b in range(2):
        n = lengths[b]
        k = np.concatenate([kp[t] for t in tables[b] if t >= 0], axis=1)[:, :n]  # (kvh, n, d)
        v = np.concatenate([vp[t] for t in tables[b] if t >= 0], axis=1)[:, :n]
        for j in range(h):
            logit = (q[b, j].astype(np.float64) @ k[j // 2].T) * d ** -0.5
            p = np.exp(logit - logit.max())
            np.testing.assert_allclose(out[b, j].numpy(), (p / p.sum()) @ v[j // 2],
                                       rtol=1e-5, atol=1e-6)


def test_paged_decode_supported_states_the_kernel_shapes():
    assert tpa.paged_decode_supported(32, 32, 128, 128)
    assert tpa.paged_decode_supported(32, 8, 64, 16)
    assert not tpa.paged_decode_supported(32, 8, 96, 128)   # head_dim
    assert not tpa.paged_decode_supported(32, 8, 128, 24)   # block size
    assert not tpa.paged_decode_supported(24, 8, 128, 128)  # 3 query heads a kv head
    assert not tpa.paged_decode_supported(64, 4, 128, 128)  # 16


def test_wrappers_reject_other_devices():
    m = dict(device="meta")
    with pytest.raises(ValueError):
        tda.decode_attention_int8(torch.empty(1, 1, 2, 64, **m),
                                  torch.empty(1, 8, 2, 64, dtype=torch.int8, **m),
                                  torch.empty(1, 8, 2, 64, dtype=torch.int8, **m),
                                  torch.empty(1, 8, 2, **m), torch.empty(1, 8, 2, **m),
                                  torch.empty(1, dtype=torch.int32, **m))
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(torch.empty(1, 2, 64, **m), torch.empty(3, 2, 16, 64, **m),
                                   torch.empty(3, 2, 16, 64, **m),
                                   torch.empty(1, 2, dtype=torch.int32, **m),
                                   torch.empty(1, dtype=torch.int32, **m))


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_llama_kv_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def counted(fn, *args):
        before = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        return out.float()

    def within(out, ref, c):
        # bf16 output rounding plus c |ref|max of summation order (fp32 P)
        return ((out - ref).abs() <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all()

    # B8: head dims 64 and 128, group sizes 1, 4, 8, a strided cache slice, a
    # length of 0 (zeros) and a length of 1
    for d, g, lengths, L in [(128, 1, [4095], 4096), (128, 4, [4000, 1500], 4096),
                             (64, 8, [700, 0], 700), (64, 2, [1, 300], 301)]:
        b, kvh = len(lengths), 4
        q = torch.randn((b, 1, kvh * g, d), generator=gen, device=dev).to(bf16)
        kv, scales = _quantize_kv(torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev))
        args = (kv[0, :, :L], kv[1, :, :L], scales[0, :, :L], scales[1, :, :L],
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        out = counted(tda.decode_attention_int8, q, *args)
        ref = tda.decode_attention_int8_ref(q.float(), *args)
        assert within(out, ref, 1e-5), (d, g, lengths)
    # B9: a fragmented pool, GQA, bs 16 and 128, a sequence of one key
    for d, g, bs, lengths in [(128, 1, 128, [2127, 257, 1]), (128, 4, 128, [3000, 128]),
                              (64, 8, 16, [33, 1, 16])]:
        b, kvh = len(lengths), 4
        n_blocks = [-(-n // bs) for n in lengths]
        ids = torch.randperm(sum(n_blocks), generator=torch.Generator().manual_seed(d)).tolist()
        tables = torch.full((b, max(n_blocks) + 1), -1, dtype=torch.int32)
        for i, n in enumerate(n_blocks):
            tables[i, :n] = torch.tensor(ids[sum(n_blocks[:i]):sum(n_blocks[:i + 1])])
        pool = torch.randn((2, sum(n_blocks), kvh, bs, d), generator=gen, device=dev).to(bf16)
        q = torch.randn((b, kvh * g, d), generator=gen, device=dev).to(bf16)
        args = (pool[0], pool[1], tables.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                                               device=dev))
        out = counted(tpa.paged_decode_attention, q, *args)
        ref = tpa.paged_decode_attention_ref(q.float(), *args)
        assert within(out, ref, 1e-6), (d, g, bs, lengths)
    # shapes outside the kernels raise on the card
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    i8 = dict(dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # head_dim 96
        tda.decode_attention_int8(torch.zeros(1, 1, 2, 96, dtype=bf16, device=dev),
                                  torch.zeros(1, 8, 2, 96, **i8), torch.zeros(1, 8, 2, 96, **i8),
                                  torch.ones(1, 8, 2, device=dev), torch.ones(1, 8, 2, device=dev),
                                  lens)
    with pytest.raises(ValueError):  # a bf16 cache
        tda.decode_attention_int8(torch.zeros(1, 1, 2, 64, dtype=bf16, device=dev),
                                  torch.zeros(1, 8, 2, 64, dtype=bf16, device=dev),
                                  torch.zeros(1, 8, 2, 64, dtype=bf16, device=dev),
                                  torch.ones(1, 8, 2, device=dev), torch.ones(1, 8, 2, device=dev),
                                  lens)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    for h, kvh, d, bs in [(2, 2, 128, 8), (3, 1, 128, 16), (2, 2, 96, 16)]:
        with pytest.raises(ValueError):
            tpa.paged_decode_attention(torch.zeros(1, h, d, dtype=bf16, device=dev),
                                       torch.zeros(1, kvh, bs, d, dtype=bf16, device=dev),
                                       torch.zeros(1, kvh, bs, d, dtype=bf16, device=dev),
                                       table, lens)
