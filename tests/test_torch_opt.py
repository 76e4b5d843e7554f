"""The port's OPT (paddlemix_tpu_torch.models.opt), BLIP-2's language model,
against the JAX package on shared weights, in fp32 on the CPU: the
cache-free logits (with and without packed segments, relu and gelu), the
prefill and decode logits over the dense cache, and the tokens of the
Llama's `greedy_generate`, which serves both packages' OPT; an HF-keyed
checkpoint through both packages' `from_pretrained`.

A tiny OPT (tests/test_blip2.py's TINY_OPT widths) is initialised by the
JAX package, every leaf then moved by seeded noise (so that norms and biases
are not 1 / 0), and carried over by `core.convert.OPT_KEY_MAP`, every key
consumed. Also shown: the port's prefill does not depend on the spare slots
of the cache (the JAX package's attends over every slot but the last).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import greedy_generate as jgreedy_generate
from paddlemix_tpu.models.opt import OPTConfig as JOPTConfig
from paddlemix_tpu.models.opt import OPTForCausalLM as JOPTForCausalLM
from paddlemix_tpu.ops.attention import SegmentIds as JSegmentIds
from paddlemix_tpu_torch.core import OPT_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.llama import greedy_generate
from paddlemix_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from paddlemix_tpu_torch.ops.attention import SegmentIds

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=64)
# fp32 on both sides: the sums' order differs (flax's LayerNorm takes the
# variance as E[x^2] - E[x]^2, the port's B10 plain version two-pass; XLA's
# dots), ~1e-6 of |logits|max
ATOL, RTOL = 2e-5, 1e-4


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(np.asarray(v, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32))
         for k, v in flat.items()})


def _pair(**overrides):
    """(JAX model, port model) on the same noisy weights."""
    cfg = dict(TINY, **overrides)
    jmodel = JOPTForCausalLM.from_config(JOPTConfig(**cfg), seed=0)
    jmodel = JOPTForCausalLM(jmodel.config, params=_noisy(jmodel.params, 1))
    model = OPTForCausalLM(OPTConfig(**cfg)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   OPT_KEY_MAP))
    return jmodel, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _close(ref, out):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_cache_free_logits_match_jax(activation):
    jmodel, model = _pair(activation_function=activation)
    ids = np.random.RandomState(0).randint(0, 96, size=(2, 11)).astype(np.int32)
    jl, _ = jmodel(jnp.asarray(ids))
    with torch.inference_mode():
        tl, cache = model(torch.from_numpy(ids).long())
    assert cache is None and tl.shape == (2, 11, 96)
    _close(jl, tl)


def test_cache_free_logits_with_packed_segments_match_jax(pair):
    """Two samples packed in a row: positions restart, segment ids keep them
    apart (the cache-free forward's training form)."""
    jmodel, model = pair
    ids = np.random.RandomState(1).randint(0, 96, size=(1, 12)).astype(np.int32)
    pos = np.concatenate([np.arange(7), np.arange(5)])[None].astype(np.int32)
    seg = np.asarray([[1] * 7 + [2] * 5], np.int32)
    jl, _ = jmodel(jnp.asarray(ids), jnp.asarray(pos),
                   segment_ids=JSegmentIds(jnp.asarray(seg), jnp.asarray(seg)))
    with torch.inference_mode():
        s = torch.from_numpy(seg)
        tl, _ = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                      segment_ids=SegmentIds(s, s))
    _close(jl, tl)


def _prompts(lengths, width, seed=0):
    """Right-padded prompts: ids, mask and positions (-1 on padding)."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rs.randint(3, 96, size=n)
        mask[i, :n] = 1
    pos = np.where(mask > 0, np.cumsum(mask, axis=-1) - 1, -1).astype(np.int32)
    return ids, mask, pos


def test_prefill_and_decode_logits_over_the_cache_match_jax(pair):
    """A right-padded batch: the prefill's logits at the valid positions, then
    three decode steps (B7's plain version on the port's side, JAX's
    attention_xla with its -1e9 bias over the cache)."""
    jmodel, model = pair
    ids, mask, pos = _prompts([9, 5], 9)
    jcache, cache = jmodel.init_cache(2, 16), model.init_cache(2, 16)
    assert cache.k.dtype == torch.float32 and cache.k.shape[2] == 17  # + the parking slot
    jl, jcache = jmodel(jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    with torch.inference_mode():
        tl, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                          cache=cache)
    valid = mask.astype(bool)
    _close(np.asarray(jl)[valid], tl[torch.from_numpy(valid)])
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    tok = np.asarray(jl)[np.arange(2), mask.sum(-1) - 1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jcache = jmodel(jnp.asarray(tok), jcache.lengths[:, None], cache=jcache)
        with torch.inference_mode():
            tl, cache = model(torch.from_numpy(tok).long(), cache.lengths[:, None].long(),
                              cache=cache)
        _close(jl, tl)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))


@pytest.mark.parametrize("eos", [None, -1], ids=["eos_2", "no_eos"])
def test_greedy_generate_tokens_equal_jax(pair, eos):
    """The Llama's greedy_generate over OPT: the same tokens as JAX's (which
    pads the prompt to its bucket; the port needs none), with OPT's eos 2 and
    with none."""
    jmodel, model = pair
    ids, mask, _ = _prompts([7, 4, 6], 7, seed=3)
    kw = {} if eos is None else dict(eos_token_id=eos)
    want = np.asarray(jgreedy_generate(jmodel, jnp.asarray(ids), jnp.asarray(mask),
                                       max_new_tokens=8, **kw))
    got = greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          max_new_tokens=8, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_does_not_depend_on_spare_cache_slots(pair):
    """The port's prefill attends over the keys up to the last position alone:
    caches of 10 and 200 slots give the same logits, bit for bit, and the
    same first token of generate (a prefill over every slot, masked by the
    bias as the JAX OPT's, sums a longer key axis in another order)."""
    _, model = pair
    ids, mask, pos = _prompts([9, 6], 9, seed=7)
    ids_t, pos_t = torch.from_numpy(ids).long(), torch.from_numpy(pos).long()
    valid = torch.from_numpy(mask.astype(bool))
    with torch.inference_mode():
        short, _ = model(ids_t, pos_t, cache=model.init_cache(2, 10))
        long, _ = model(ids_t, pos_t, cache=model.init_cache(2, 200))
        assert torch.equal(short[valid], long[valid])
        one = greedy_generate(model, ids_t, torch.from_numpy(mask), max_new_tokens=1)
        many = greedy_generate(model, ids_t, torch.from_numpy(mask), max_new_tokens=40)
        assert torch.equal(one[:, 0], many[:, 0])



def test_config_refuses_what_the_jax_module_does_not_build():
    for bad in (dict(do_layer_norm_before=False), dict(word_embed_proj_dim=16),
                dict(activation_function="silu")):
        with pytest.raises(NotImplementedError):
            OPTConfig(**dict(TINY, **bad))
    cfg = OPTConfig(**TINY)
    assert (cfg.kv_heads, cfg.head_dim_) == (2, 16)
    assert dataclasses.replace(cfg, word_embed_proj_dim=32).word_embed_proj_dim == 32


def test_hf_checkpoint_loads_as_the_jax_package_loads_it(tmp_path):
    """A tiny transformers OPTForCausalLM saved to a directory: the port's
    from_pretrained (HF names, the tied lm_head dropped, the position table
    kept (max + 2, D)) and the JAX package's give the same logits."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=64, word_embed_proj_dim=32, do_layer_norm_before=True)).eval()
    with torch.no_grad():  # norms and biases away from 1 / 0
        for p in hf.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    model = OPTForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    jmodel = JOPTForCausalLM.from_pretrained(str(tmp_path))
    ids = np.asarray([[2, 5, 9, 11, 40, 7]], np.int32)
    jl, _ = jmodel(jnp.asarray(ids))
    with torch.inference_mode():
        tl, _ = model(torch.from_numpy(ids).long())
    _close(jl, tl)
