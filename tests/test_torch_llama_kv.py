"""The port's Llama serving caches (paddlemix_tpu_torch.models.llama): the
int8 KV cache (`cachekv_int8`, `Int8KVCache`) and the paged KV cache
(`PagedKVCache`, `paged_greedy_generate`) against the JAX package on shared
weights, in fp32 on the CPU.

Tiny Llamas are initialised by the JAX package and carried over by
`core.convert.LLAMA_KEY_MAP`, every key consumed: one with two query heads
of 128 on one kv head (the widths at which the JAX Pallas kernels run), and
test_paged_kv.py's TINY (heads of 16). The JAX side runs both of its decode
branches: the XLA fallback, and its Pallas kernels in interpret mode (B8 at
2048 cache slots, B9 at block size 128), counted by their `pallas_call`s.
Compared: prefill and decode logits, greedy tokens, block allocation and the
dense view of the pool. Also shown: the JAX paged cache's parking write
overwrites the first sequence's key at position bs - 1 in a right-padded
batch, and the port's does not. The launch derivation is checked at full
width on the meta device.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.models.llama import greedy_generate as jgreedy_generate
from paddlemix_tpu.models.llama.paged import PagedKVCache as JPagedKVCache
from paddlemix_tpu.models.llama.paged import paged_greedy_generate as jpaged_greedy_generate
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.llama import (
    Int8KVCache,
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    PagedKVCache,
    blocks_needed,
    expected_launches_llama,
    greedy_generate,
    llama2_7b_config,
    paged_greedy_generate,
)
from paddlemix_tpu_torch.models.llama.llama7b import (
    INT8KV_NEW_TOKENS,
    INT8KV_PROMPT_LEN,
    PAGED_BLOCK_SIZE,
    PAGED_NEW_TOKENS,
    PAGED_PROMPT_LENS,
)
from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port

# importlib: the JAX package re-exports functions under these modules' names
jda = importlib.import_module("paddlemix_tpu.ops.decode_attention")
jpa = importlib.import_module("paddlemix_tpu.ops.paged_attention")

WIDE = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=4096,
            eos_token_id=2)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            eos_token_id=2)
# fp32 on both sides: summation order, and the JAX quantizer's scale one fp32
# ulp apart where XLA fuses absmax / 127 (the eager quantizer is bit-exact,
# tests/test_torch_llama_kv_kernels.py); the tolerance of tests/test_paged_kv.py
TOL = 2e-3


def _port(jmodel, **overrides):
    cfg = dict(WIDE if jmodel.config.head_dim_ == 128 else TINY, **overrides)
    model = LlamaForCausalLM(LlamaConfig(**cfg)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    return model


@pytest.fixture(scope="module")
def wide():
    return JLlamaForCausalLM.from_config(JLlamaConfig(**WIDE), seed=0)


@pytest.fixture(scope="module")
def tiny():
    return JLlamaForCausalLM.from_config(JLlamaConfig(**TINY), seed=0)


@pytest.fixture
def backend(request, monkeypatch):
    """The JAX decode branch: "xla", or "pallas" (kernels in interpret mode)."""
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", request.param)
    if request.param == "pallas":
        monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    return request.param


def _count_pallas_calls(monkeypatch, module):
    calls = []
    pallas_call = module.pl.pallas_call
    monkeypatch.setattr(module.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    return calls


def _prompts(lengths, vocab, seed=0):
    """Right-padded ids, the mask and the positions (-1 on padding), numpy."""
    rs = np.random.RandomState(seed)
    s = max(lengths)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = rs.randint(3, vocab, size=(len(lengths), s)).astype(np.int32) * mask
    pos = np.where(mask > 0, np.cumsum(mask, -1) - 1, -1).astype(np.int32)
    return ids, mask, pos


def _steps(jmodel, jcache, model, cache, ids, pos, steps, on_decode=lambda: None):
    """Prefill then `steps` decode steps through both, fed JAX's greedy
    tokens: [(JAX logits, port logits)] of the prefill and each step."""
    jl, jcache = jmodel(jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    with torch.inference_mode():
        tl, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(), cache=cache)
    out = [(np.asarray(jl), tl.numpy())]
    last = np.asarray(jl)[np.arange(len(ids)), (pos >= 0).sum(-1) - 1]
    on_decode()
    for _ in range(steps):
        tok = last.argmax(-1).astype(np.int32)[:, None]
        jl, jcache = jmodel(jnp.asarray(tok), jcache.lengths[:, None], cache=jcache)
        with torch.inference_mode():
            tl, cache = model(torch.from_numpy(tok).long(), cache.lengths[:, None].long(),
                              cache=cache)
        out.append((np.asarray(jl), tl.numpy()))
        last = np.asarray(jl)[:, -1]
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    return out


def _assert_steps_close(pairs, mask):
    (jpre, tpre), *decode = pairs
    valid = mask.astype(bool)  # padded queries attend to nothing real
    np.testing.assert_allclose(tpre[valid], jpre[valid], atol=TOL, rtol=0)
    for jl, tl in decode:
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)


# --------------------------------------------------------------- int8 KV cache
@pytest.mark.parametrize("backend", ["xla", "pallas"], indirect=True)
def test_int8_cache_logits_match_jax(wide, backend, monkeypatch):
    """Prefill and 4 decode steps over the int8 cache, a right-padded batch of
    two; JAX's Pallas B8 runs at 2048 cache slots, its XLA fallback below."""
    jmodel = JLlamaForCausalLM(JLlamaConfig(**WIDE, cachekv_int8=True), params=wide.params)
    model = _port(wide, cachekv_int8=True)
    ids, mask, pos = _prompts([12, 7], 256)
    max_len = 2048 if backend == "pallas" else 24
    jcache, cache = jmodel.init_cache(2, max_len), model.init_cache(2, max_len)
    assert isinstance(cache, Int8KVCache) and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == (2, 2, max_len + 1, 1) and cache.max_len == max_len
    calls = []
    pairs = _steps(jmodel, jcache, model, cache, ids, pos, 4,
                   lambda: calls.append(_count_pallas_calls(monkeypatch, jda)))
    assert len(calls[0]) == (4 * 2 if backend == "pallas" else 0)  # B8, once a layer a step
    _assert_steps_close(pairs, mask)
    assert tda.decode_attention_int8.launches == 0  # the CPU runs the plain version
    # the prefill attends over the dequantized cache: the fresh keys carry their rounding
    dense = _port(wide)
    with torch.inference_mode():
        ref, _ = dense(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                       cache=dense.init_cache(2, max_len))
    assert 1e-5 < np.abs(ref.numpy() - pairs[0][1])[mask.astype(bool)].max() < 5e-2


def test_int8_cache_greedy_tokens_equal_jax(wide):
    jmodel = JLlamaForCausalLM(JLlamaConfig(**WIDE, cachekv_int8=True), params=wide.params)
    model = _port(wide, cachekv_int8=True)
    ids, mask, _ = _prompts([10, 6], 256, seed=1)
    ref = jgreedy_generate(jmodel, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8,
                           eos_token_id=-1, bucket=None)
    out = greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          max_new_tokens=8, eos_token_id=-1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -------------------------------------------------------------- paged KV cache
@pytest.mark.parametrize("backend", ["xla", "pallas"], indirect=True)
@pytest.mark.parametrize("lengths", [[9], [9, 9]], ids=["batch1", "batch2"])
def test_paged_cache_logits_match_jax(wide, backend, lengths, monkeypatch):
    """Prefill and 4 decode steps over the paged cache, at batch 1 and at an
    equal-length batch; JAX's Pallas B9 runs at block size 128, its XLA
    fallback at 4 (the next block is taken on the way)."""
    model = _port(wide)
    ids, mask, pos = _prompts(lengths, 256, seed=len(lengths))
    bs = 128 if backend == "pallas" else 4
    b, nb = len(lengths), -(-(9 + 4) // bs)
    jcache = JPagedKVCache.create(wide.config, b, b * nb, bs, nb, dtype=jnp.float32)
    cache = PagedKVCache.create(model.config, b, b * nb, bs, nb, dtype=torch.float32,
                                device="cpu")
    calls = []
    pairs = _steps(wide, jcache, model, cache, ids, pos, 4,
                   lambda: calls.append(_count_pallas_calls(monkeypatch, jpa)))
    assert len(calls[0]) == (4 * 2 if backend == "pallas" else 0)  # B9, once a layer a step
    _assert_steps_close(pairs, mask)
    assert tpa.paged_decode_attention.launches == 0


@pytest.mark.parametrize("backend", ["xla", "pallas"], indirect=True)
def test_paged_greedy_tokens_equal_jax(wide, backend):
    model = _port(wide)
    ids, mask, _ = _prompts([7, 7], 256, seed=3)
    bs = 128 if backend == "pallas" else 4
    ref = jpaged_greedy_generate(wide, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8,
                                 block_size=bs, eos_token_id=-1)
    out = paged_greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                max_new_tokens=8, block_size=bs, eos_token_id=-1)
    assert out.dtype == torch.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    dense = greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                            max_new_tokens=8, eos_token_id=-1)
    np.testing.assert_array_equal(out.numpy(), dense.numpy())


def test_block_allocation_equals_jax_step_by_step(tiny):
    """test_paged_kv.py's lazy allocation, the port beside JAX: the same
    tables and watermark after every step."""
    jcache = JPagedKVCache.create(tiny.config, batch=2, num_blocks=8, block_size=4,
                                  max_blocks_per_seq=4, dtype=jnp.float32)
    cache = PagedKVCache.create(LlamaConfig(**TINY), batch=2, num_blocks=8, block_size=4,
                                max_blocks_per_seq=4, dtype=torch.float32, device="cpu")
    assert int(cache.num_allocated) == 0 and cache.num_blocks == 8 and cache.max_len == 16
    assert cache.k_pool.shape == (2, 9, 2, 4, 16)  # the parking block, index 8
    steps = [[[0, 1, 2, -1, -1, -1], [0, 1, 2, 3, 4, 5]], [[3], [6]], [[4], [7]],
             [[5], [8]], [[-1], [9]]]
    for want, positions in zip([3, 3, 4, 5, 5], steps):
        jcache = jcache.allocate_for(jnp.asarray(positions))
        assert cache.allocate_for(torch.tensor(positions)) is cache
        np.testing.assert_array_equal(cache.block_tables.numpy(), np.asarray(jcache.block_tables))
        assert int(cache.num_allocated) == int(jcache.num_allocated) == want
    assert cache.block_tables.tolist() == [[0, 3, -1, -1], [1, 2, 4, -1]]


def test_layer_view_equals_jax_but_at_its_parking_slot(tiny):
    """The same writes into both pools: the dense views agree at every live
    position but the one JAX parks padding on (block 0, row bs - 1, the first
    sequence's position 3), where the port keeps the sequence's key."""
    kw = dict(batch=2, num_blocks=6, block_size=4, max_blocks_per_seq=3)
    jcache = JPagedKVCache.create(tiny.config, dtype=jnp.float32, **kw)
    cache = PagedKVCache.create(LlamaConfig(**TINY), dtype=torch.float32, device="cpu", **kw)
    _, _, pos = _prompts([8, 3], 128)
    rs = np.random.RandomState(4)
    k, v = (rs.randn(2, 8, 2, 16).astype(np.float32) for _ in range(2))
    jcache = jcache.allocate_for(jnp.asarray(pos)).update(0, jnp.asarray(k), jnp.asarray(v),
                                                          jnp.asarray(pos))
    cache.allocate_for(torch.from_numpy(pos).long())
    cache.update(0, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos).long())
    (jk, jv), (tk, tv) = jcache.layer_view(0), cache.layer_view(0)
    assert tk.shape == (2, 12, 2, 16)
    live = pos >= 0
    for j, t, x in ((jk, tk, k), (jv, tv, v)):
        np.testing.assert_array_equal(t.numpy()[:, :8][live], x[live])  # the port: every key
        j = np.asarray(j)[:, :8]
        parked = np.zeros_like(live)
        parked[0, 3] = True
        np.testing.assert_array_equal(j[live & ~parked], x[live & ~parked])
        assert np.abs(j[0, 3] - x[0, 3]).max() > 0.1  # JAX: sequence 1's padding landed there


def test_padded_batch_matches_each_sequence_alone(tiny):
    """A right-padded mixed batch through the paged prefill and two decode
    steps gives each sequence the logits it gets alone over the dense cache.
    Through JAX it does not: from the first sequence's position bs - 1 = 3 on,
    its keys are the second sequence's padding."""
    model = _port(tiny)
    ids, mask, pos = _prompts([8, 3], 128, seed=5)
    with torch.inference_mode():
        cache = PagedKVCache.create(model.config, 2, 6, 4, 3, dtype=torch.float32, device="cpu")
        pre, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                           cache=cache)
        toks = torch.tensor([[5], [6]])
        dec = []
        for _ in range(2):
            step, cache = model(toks, cache.lengths[:, None].long(), cache=cache)
            dec.append(step[:, 0])
        for i, n in enumerate([8, 3]):
            alone = model.init_cache(1, 10)
            ref, alone = model(torch.from_numpy(ids[i:i + 1, :n]).long(), cache=alone)
            np.testing.assert_allclose(pre[i, :n].numpy(), ref[0].numpy(), atol=TOL, rtol=0)
            for step in dec:
                ref, alone = model(toks[i:i + 1], alone.lengths[:, None].long(), cache=alone)
                np.testing.assert_allclose(step[i].numpy(), ref[0, 0].numpy(), atol=TOL, rtol=0)
    # the JAX paged cache, the same batch, against the first sequence alone
    jcache = JPagedKVCache.create(tiny.config, 2, 6, 4, 3, dtype=jnp.float32)
    jpre, _ = tiny(jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    jalone, _ = tiny(jnp.asarray(ids[:1]), jnp.asarray(pos[:1]), cache=tiny.init_cache(1, 10))
    gap = np.abs(np.asarray(jpre)[0] - np.asarray(jalone)[0]).max(axis=-1)
    assert (gap[:3] < TOL).all() and gap[3] > 0.1, gap


def test_paged_generate_refuses_a_pool_too_small(tiny):
    model = _port(tiny)
    ids, mask, _ = _prompts([8, 3], 128)
    need = blocks_needed([8, 3], 6, 4)
    assert need == 4 + 3
    with pytest.raises(ValueError, match="num_blocks 6 < 7"):
        paged_greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                              max_new_tokens=6, block_size=4, num_blocks=need - 1)
    out = paged_greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                max_new_tokens=6, block_size=4, num_blocks=need, eos_token_id=-1)
    dense = greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                            max_new_tokens=6, eos_token_id=-1)
    np.testing.assert_array_equal(out.numpy(), dense.numpy())


# ------------------------------------------------------------- at full width
def test_launch_derivation_and_cache_bytes_at_full_width_on_meta():
    with torch.device("meta"):
        model = LlamaForCausalLM(llama2_7b_config())
    cfg = model.config
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim_,
            cfg.intermediate_size, cfg.vocab_size) == (32, 4096, 32, 128, 11008, 32000)
    base = {"decode_attention": 0, "decode_attention_int8": 0, "paged_decode_attention": 0,
            "rms_norm": 65 * 128, "wint8_matmul": 0, "flash_attention": 0}
    for cache, name in (("dense", "decode_attention"), ("int8", "decode_attention_int8"),
                        ("paged", "paged_decode_attention")):
        lens = PAGED_PROMPT_LENS if cache == "paged" else [INT8KV_PROMPT_LEN]
        assert expected_launches_llama(model, lens, 128, cache) == dict(base, **{name: 32 * 127})
        assert expected_launches_llama(model, lens, 1, cache) == dict(base, rms_norm=65)
    assert expected_launches_llama(model, [1], 2, "int8")["decode_attention_int8"] == 64
    assert INT8KV_PROMPT_LEN + INT8KV_NEW_TOKENS == cfg.max_position_embeddings
    # the paged batch's pool: 67 blocks (and the parking one) against a dense cache
    need = blocks_needed(PAGED_PROMPT_LENS, PAGED_NEW_TOKENS, PAGED_BLOCK_SIZE)
    assert need == 67
    pool = PagedKVCache.create(cfg, 8, need, PAGED_BLOCK_SIZE, 17, device="meta")
    per_block = 2 * 32 * 32 * 128 * 128 * 2
    assert 2 * pool.k_pool.numel() * 2 == (need + 1) * per_block
    assert need * per_block == 4496293888
    dense = KVCache.create(cfg, 8, max(PAGED_PROMPT_LENS) + PAGED_NEW_TOKENS, device="meta")
    assert 2 * dense.k.numel() * 2 == 8929673216
    i8 = Int8KVCache.create(cfg, 1, INT8KV_PROMPT_LEN + INT8KV_NEW_TOKENS, device="meta")
    assert 2 * i8.k.numel() + 2 * 4 * i8.k_scale.numel() == 2 * 32 * 4097 * 32 * (128 + 4)
