"""The port's LLaVA slice (paddlemix_tpu_torch.models.llava / .llama) against
the JAX package on shared weights, in fp32 on the CPU, under quant None,
weight-only int8 and the dynamic a8w8 / a8w4.

A tiny LLaVA (ViT 32 wide at 28 px / patch 14, Llama 128 wide with 2 heads
of 64 sharing one kv head, vocab 256, the image token the last id) is
initialised by the JAX package; its parameters are carried over by
`core.convert.llava_key_to_flax`, every key consumed. For wint8 and a8w8 the
JAX language model's parameters are quantized with `quantize_tree_wint8
(min_bytes=0)`, for a8w4 with `quantize_tree_int4(min_bytes=0)`, and the
port's modules take its `kernel_q` / `scale`. The JAX
side runs its Pallas kernels in interpret mode: RMSNorm over the 68-token
prefill and the wint8 GEMM (its decode rows are padded to 8). Compared:
encode_images, the splice, prefill logits, one decode step and the greedy
tokens of `generate`. The launch derivation is checked at full width on the
meta device.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.models.llava import LlavaConfig as JLlavaConfig
from paddlemix_tpu.models.llava import LlavaForConditionalGeneration as JLlava
from paddlemix_tpu.ops.quant import quantize_tree_int4, quantize_tree_wint8
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict, llava_key_to_flax
from paddlemix_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    MXUDense,
    SamplingConfig,
    sample_token,
)
from paddlemix_tpu_torch.models.llava import (
    LlavaConfig,
    LlavaForConditionalGeneration,
    expected_launches_llava,
    llava7b_config,
)
from paddlemix_tpu_torch.ops.decode_attention import decode_attention_int8
from paddlemix_tpu_torch.ops.quant import a8w4_matmul, a8w8_matmul, wint8_matmul

pytestmark = pytest.mark.torch_port

VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
              image_size=28, patch_size=14)
TEXT = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
            eos_token_id=2)
TINY = dict(vision_config=VISION, text_config=TEXT, image_token_index=255)
TEXT_LEN = 64  # prompt: 4 image tokens + 64 text ids, so JAX's RMSNorm kernel runs
NEW_TOKENS = 6


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMIX_KERNEL_BACKEND", "pallas")
        mp.setenv("PMIX_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    ids = rs.randint(3, 250, size=(1, 4 + TEXT_LEN)).astype(np.int32)
    ids[:, 1:5] = TINY["image_token_index"]
    px = rs.randn(1, 28, 28, 3).astype(np.float32)  # NHWC, as the JAX package takes it
    return ids, px


@pytest.fixture(scope="module")
def jax_bf16_path():
    return JLlava.from_config(JLlavaConfig.from_dict(TINY), seed=0)


def _port(jmodel, quant):
    model = LlavaForConditionalGeneration(LlavaConfig(**TINY)).eval()
    if quant:
        model.quantize_(quant)
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   llava_key_to_flax))
    return model


@pytest.fixture(scope="module", params=[None, "wint8", "a8w8", "a8w4"],
                ids=["bf16_path", "wint8", "a8w8", "a8w4"])
def pair(request, jax_bf16_path):
    """(JAX model, port model, quant) on the same weights."""
    quant = request.param
    jmodel = jax_bf16_path
    if quant:
        params = dict(jmodel.params)
        # the quantizer frees each kernel it replaces: quantize a copy
        tree_fn = quantize_tree_int4 if quant == "a8w4" else quantize_tree_wint8
        params["language_model"] = tree_fn(
            jax.tree_util.tree_map(jnp.copy, params["language_model"]), min_bytes=0)
        text = dict(TEXT, quant=quant)
        jmodel = JLlava(JLlavaConfig.from_dict(dict(TINY, text_config=text)), params=params)
    return jmodel, _port(jmodel, quant), quant


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


# wint8 rounds every projection's input to bf16 (both packages). Each op
# agrees to 3e-7 on the same input, but an fp32 difference in the last bits
# upstream moves some of those roundings by one bf16 ulp (2**-8 relative),
# and the flips add up over the layers: measured 2.2e-2 on logits of |max| 4
# (0.55%), from the seventh prompt position on. fp32 alone: summation order.
# a8w8 / a8w4 round every projection's input per row to int8 steps of
# |x|max / 127. Each op is bit-exact with JAX's on the same input (held in
# test_torch_llama_quant.py; here on the port's own inputs too), but an fp32
# difference in the last bits upstream (summation order in attention and the
# norms) moves an x / sx lying that close to a .5 tie by a whole step, a far
# larger jump than a bf16 ulp: measured 9.5e-7 under a8w8 (no step moved at
# these weights) and 1.1e-2 of |logits|max 4.1 under a8w4, from the seventh
# prompt position on, while the decode step read 0. A wrong nibble order or
# scale moves the logits by O(1).
LOGIT_TOL = {None: 1e-4, "wint8": 1e-2, "a8w8": 2e-2, "a8w4": 2e-2}


def test_encode_images(pair, inputs):
    jmodel, model, _ = pair
    ids, px = inputs
    ref = jmodel.encode_images(jnp.asarray(px))
    with torch.inference_mode():
        out = model.encode_images(torch.from_numpy(px))
    assert out.shape == (1, 4, 128)
    _assert_close(ref, out, 1e-5)  # fp32, summation order only


def test_splice(pair, inputs):
    jmodel, model, _ = pair
    ids, px = inputs
    feats = np.asarray(jmodel.encode_images(jnp.asarray(px)))
    ref = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(ids), jnp.asarray(feats),
                              method=jmodel.module.splice_image_features)
    with torch.inference_mode():
        out = model.splice_image_features(torch.from_numpy(ids).long(), torch.tensor(feats))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))  # a gather: exact
    np.testing.assert_array_equal(out[0, 1:5].numpy(), feats[0])


def _prefill_and_step(jmodel, model, ids, px):
    """Prefill logits, the greedy next token, and the logits of one decode step."""
    s = ids.shape[1]
    jcache = jmodel.init_cache(1, s + 4)
    jpos = jnp.arange(s)[None]
    jlogits, jcache = jmodel(jnp.asarray(ids), jnp.asarray(px), jpos, cache=jcache)
    tok = np.asarray(jlogits[:, -1].argmax(-1)).astype(np.int32)[:, None]
    jstep, _ = jmodel(jnp.asarray(tok), None, jcache.lengths[:, None], cache=jcache)
    with torch.inference_mode():
        cache = model.init_cache(1, s + 4)
        logits, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(px),
                              torch.arange(s)[None], cache=cache)
        assert cache.lengths.tolist() == [s]
        step, cache = model(torch.from_numpy(tok).long(), None, cache.lengths[:, None].long(),
                            cache=cache)
        assert cache.lengths.tolist() == [s + 1]
    return (jlogits, logits), (jstep, step)


def test_prefill_and_decode_logits(pair, inputs):
    jmodel, model, quant = pair
    counters = (wint8_matmul, a8w8_matmul, a8w4_matmul)
    before = [fn.launches for fn in counters]
    (jlogits, logits), (jstep, step) = _prefill_and_step(jmodel, model, *inputs)
    assert logits.shape == (1, 68, 256) and step.shape == (1, 1, 256)
    _assert_close(jlogits, logits, LOGIT_TOL[quant])
    _assert_close(jstep, step, LOGIT_TOL[quant])
    assert [fn.launches for fn in counters] == before  # the CPU runs the plain versions


def test_generate_tokens_equal(pair, inputs):
    jmodel, model, _ = pair
    ids, px = inputs
    ref = np.asarray(jmodel.generate(jnp.asarray(ids), jnp.asarray(px),
                                     max_new_tokens=NEW_TOKENS, eos_token_id=-1))
    out = model.generate(torch.from_numpy(ids).long(), torch.from_numpy(px),
                         max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    assert out.dtype == torch.int32 and out.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_stops_at_eos(pair, inputs):
    """With an eos id, the tokens after it stay 0, as in the JAX loop."""
    jmodel, model, _ = pair
    ids, px = inputs
    free = model.generate(torch.from_numpy(ids).long(), torch.from_numpy(px),
                          max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    eos = int(free[0, 2])
    ref = np.asarray(jmodel.generate(jnp.asarray(ids), jnp.asarray(px),
                                     max_new_tokens=NEW_TOKENS, eos_token_id=eos))
    out = model.generate(torch.from_numpy(ids).long(), torch.from_numpy(px),
                         max_new_tokens=NEW_TOKENS, eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), ref)
    first = int(np.argmax(ref[0] == eos))
    assert (ref[0, first + 1:] == 0).all()


def test_wint8_weights_carried_over(pair, jax_bf16_path):
    _, model, quant = pair
    dense = [m for m in model.language_model.modules() if isinstance(m, MXUDense)]
    assert len(dense) == 2 * 7 + 1
    for m in dense:
        assert m.quant == quant
        assert (m.kernel_q.dtype == torch.int8) if quant else (m.weight.dtype == torch.float32)
    if quant:  # the port's own quantizer against the JAX-quantized weights
        q_proj = jax_bf16_path.params["language_model"]["layers_0"]["self_attn"]["q_proj"]
        mine = MXUDense(128, 128, bias=False)
        mine.weight.data = torch.from_numpy(np.asarray(q_proj["kernel"]).T.copy())
        mine.quantize_(quant)
        layer = model.language_model.model.layers[0].self_attn.q_proj
        assert torch.equal(mine.kernel_q, layer.kernel_q)
        # quantize_tree_wint8 / quantize_tree_int4 jit the quantizer, and XLA
        # turns absmax / 127 (/ 7) into absmax * (1 / 127): one fp32 ulp apart
        # at most (the eager JAX functions, which the port follows, are held
        # bit-exact in test_torch_llava_kernels.py and test_torch_llama_quant.py)
        torch.testing.assert_close(mine.scale, layer.scale, rtol=1.2e-7, atol=0)


# -------------------------------------------------------- Llama on its own
def test_llama_key_map_and_gqa_logits():
    """A standalone Llama (HF names model.*, lm_head) through LLAMA_KEY_MAP,
    4 query heads on 2 kv heads, a right-padded batch of 2: prefill and one
    decode step."""
    cfg = dict(vocab_size=128, hidden_size=128, intermediate_size=192, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    jmodel = JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(cfg), seed=1)
    model = LlamaForCausalLM(LlamaConfig(**cfg)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    rs = np.random.RandomState(1)
    ids = rs.randint(3, 128, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    pos = np.where(mask > 0, np.cumsum(mask, -1) - 1, -1).astype(np.int32)
    jcache = jmodel.init_cache(2, 16)
    jlogits, jcache = jmodel(jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    tok = np.array([[7], [9]], np.int32)
    jstep, _ = jmodel(jnp.asarray(tok), jcache.lengths[:, None], cache=jcache)
    with torch.inference_mode():
        cache = model.init_cache(2, 16)
        logits, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                              cache=cache)
        assert cache.lengths.tolist() == [12, 9]
        step, _ = model(torch.from_numpy(tok).long(), cache.lengths[:, None], cache=cache)
    valid = mask.astype(bool)  # padded positions attend to nothing real
    _assert_close(np.asarray(jlogits)[valid], logits.numpy()[valid], 1e-4)
    _assert_close(jstep, step, 1e-4)


# ------------------------------------------------------------ the traps
def test_placeholder_id_past_the_vocab_is_spliced_not_looked_up():
    """LLaVA-1.5's image token is the vocab size: nn.Embedding would fault on
    it (a device assert on CUDA), flax's lookup does not."""
    cfg = LlavaConfig(vision_config=VISION, text_config=dict(TEXT, vocab_size=64),
                      image_token_index=64)
    model = LlavaForConditionalGeneration(cfg).eval()
    ids = torch.tensor([[5, 64, 64, 64, 64, 6]])
    feats = torch.randn(1, 4, 128)
    with torch.inference_mode():
        out = model.splice_image_features(ids, feats)
        with pytest.raises(IndexError):
            model.language_model.embed(ids)
    assert torch.equal(out[0, 1:5], feats[0])
    assert torch.equal(out[0, 0], model.language_model.model.embed_tokens.weight[5])


def test_projector_gelu_is_exact_below_fp32():
    model = LlavaForConditionalGeneration(LlavaConfig(**TINY)).eval().to(torch.bfloat16)
    proj = model.multi_modal_projector
    x = torch.linspace(-4, 4, 32 * 8).reshape(8, 32).to(torch.bfloat16)
    with torch.inference_mode():
        h = proj.linear_1(x)
        erf = proj.linear_2(torch.nn.functional.gelu(h, approximate="none"))
        tanh = proj.linear_2(torch.nn.functional.gelu(h, approximate="tanh"))
        out = proj(x)
    assert torch.equal(out, erf)
    assert not torch.equal(out, tanh)


def test_sampling_keeps_top_k_and_top_p_support():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0, -1.0]]).repeat(2000, 1)
    greedy = sample_token(logits, SamplingConfig())
    assert (greedy == 0).all()
    top_k = sample_token(logits, SamplingConfig(do_sample=True, top_k=3), gen)
    assert set(top_k.tolist()) == {0, 1, 2}
    # softmax: 0.6364, 0.2341, 0.0861, ...; top_p 0.8 keeps the smallest set
    # whose mass reaches it: ids 0 and 1
    top_p = sample_token(logits, SamplingConfig(do_sample=True, top_p=0.8), gen)
    assert set(top_p.tolist()) == {0, 1}
    share = (top_p == 0).float().mean().item()
    assert abs(share - 0.6364 / (0.6364 + 0.2341)) < 0.05


@pytest.mark.parametrize("quant", [None, "wint8", "a8w8", "a8w4"])
def test_launch_derivation_at_full_width_on_meta(quant):
    with torch.device("meta"):
        model = LlavaForConditionalGeneration(llava7b_config())
    if quant:
        model.quantize_(quant)
    n_dense = sum(isinstance(m, MXUDense) for m in model.language_model.modules())
    assert n_dense == 32 * 7 + 1
    want = {"rms_norm": 65 * 128, "decode_attention": 32 * 127, "flash_attention": 0,
            **{f"{mode}_matmul": 225 * 128 if quant == mode else 0
               for mode in ("wint8", "a8w8", "a8w4")},
            "layer_norm": 2 * 24 + 2}  # the ViT's blocks, pre- and post-LN
    assert expected_launches_llava(model, 576 + 32, 128) == want
    assert model.config.num_image_tokens == 576


def test_config_rejects_unported_options():
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(dict(TEXT, fused_qkv=True))
    assert LlamaConfig.from_dict(dict(TEXT, quant=None, scan_layers=False)).vocab_size == 256
    with pytest.raises(NotImplementedError):
        LlavaConfig(**dict(TINY, image_aspect_ratio="anyres"))
    assert dataclasses.asdict(LlavaConfig(**TINY))["image_token_index"] == 255


def test_llava_keeps_the_dense_cache_under_cachekv_int8(inputs):
    """The JAX LLaVA builds the bf16 KVCache whatever its text config says
    (its init_cache and the _LlamaView's), so `cachekv_int8` changes nothing:
    the port builds the dense cache too, in `init_cache` and in `generate`."""
    jmodel = JLlava.from_config(JLlavaConfig.from_dict(
        dict(TINY, text_config=dict(TEXT, cachekv_int8=True))), seed=0)
    assert type(jmodel.init_cache(1, 8)).__name__ == "KVCache"
    model = _port(jmodel, None)
    model8 = LlavaForConditionalGeneration(LlavaConfig(
        **dict(TINY, text_config=dict(TEXT, cachekv_int8=True)))).eval()
    model8.load_state_dict(model.state_dict())
    assert model8.language_model.config.cachekv_int8
    assert type(model8.language_model.init_cache(1, 8)).__name__ == "Int8KVCache"
    cache = model8.init_cache(1, 8)
    assert isinstance(cache, KVCache) and cache.k.dtype == torch.float32
    ids, px = inputs
    t = (torch.from_numpy(ids).long(), torch.from_numpy(px))
    np.testing.assert_array_equal(
        model8.generate(*t, max_new_tokens=4, eos_token_id=-1).numpy(),
        np.asarray(jmodel.generate(jnp.asarray(ids), jnp.asarray(px), max_new_tokens=4,
                                   eos_token_id=-1)))
    assert decode_attention_int8.launches == 0


@pytest.mark.parametrize("overrides", [
    dict(mm_projector_type="linear"),
    dict(mm_vision_select_feature="cls_patch"),
    dict(vision_config=dict(VISION, use_pre_layernorm=False)),
    dict(vision_config=dict(VISION, post_layernorm_full=True)),
], ids=["linear_projector", "cls_patch", "no_pre_layernorm", "post_layernorm_full"])
def test_config_rejects_unported_llava_variants(overrides):
    # only LLaVA-1.5's layout is ported: the mlp2x_gelu projector over patch
    # features of a pre-LN CLIP tower; other JAX config values are refused
    with pytest.raises(NotImplementedError):
        LlavaConfig(**dict(TINY, **overrides)).vision
