"""The port's BLIP-2 (paddlemix_tpu_torch.models.blip2) against the JAX
package on shared weights, in fp32 on the CPU: the vision tower in BLIP-2's
form (no pre-LN, the post-LN over every token, a biased patch embedding),
the Q-Former, `encode_image`, `forward` (without and over the cache) and the
greedy tokens of `generate`; a torch-keyed checkpoint of transformers'
Blip2ForConditionalGeneration through `from_pretrained` (its fused qkv
split, `projection` renamed); the configs' refusals; and the launch walk of
BLIP-2 OPT-2.7B at full width on the meta device.

The tiny BLIP-2 is tests/test_blip2.py's TINY_BLIP2 (and a variant with the
exact gelu and eps 1e-6 of the published tower). The JAX package
initialises it, every leaf is then moved by seeded noise (so that norms and
biases are not 1 / 0), and `core.convert.blip2_key_to_flax` carries it over,
every key consumed. fp32 throughout: the two sides differ by summation
order (flax's LayerNorm takes the variance as E[x^2] - E[x]^2, the port's
B10 plain version two-pass; XLA's dots), well inside atol 2e-5, rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.blip2 import Blip2Config as JBlip2Config
from paddlemix_tpu.models.blip2 import Blip2ForConditionalGeneration as JBlip2
from paddlemix_tpu_torch.core import BLIP2_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.blip2 import (
    BLIP2_OPT_2_7B,
    Blip2Config,
    Blip2ForConditionalGeneration,
    expected_launches_blip2,
)
from paddlemix_tpu_torch.models.clip import CLIPVisionConfig
from paddlemix_tpu_torch.models.layers import FusedLayerNorm, n_layer_norms
from paddlemix_tpu_torch.ops import decode_attention as tda
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port

TINY = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, image_size=16, patch_size=8),
    qformer_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64, cross_attention_frequency=2,
                        encoder_hidden_size=32),
    text_config=dict(vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                     num_attention_heads=2, max_position_embeddings=64),
    num_query_tokens=4,
)
# the published tower's activation and eps, three Q-Former layers (cross at
# 0 and 2)
PUBLISHED_FORM = dict(
    TINY, vision_config=dict(TINY["vision_config"], hidden_act="gelu", layer_norm_eps=1e-6),
    qformer_config=dict(TINY["qformer_config"], num_hidden_layers=3))
ATOL, RTOL = 2e-5, 1e-4


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(np.asarray(v, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32))
         for k, v in flat.items()})


def _pair(cfg):
    jmodel = JBlip2.from_config(JBlip2Config.from_dict(cfg), seed=0)
    jmodel = JBlip2(jmodel.config, params=_noisy(jmodel.params, 1))
    model = Blip2ForConditionalGeneration(Blip2Config.from_dict(cfg)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   BLIP2_KEY_MAP))
    return jmodel, model


@pytest.fixture(scope="module", params=["tiny", "published_form"])
def pair(request):
    return _pair(TINY if request.param == "tiny" else PUBLISHED_FORM)


def _pixels(batch, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 16, 16, 3)).astype(np.float32)


def _close(ref, out):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _apply(jmodel, fn, *args):
    return jmodel.module.apply({"params": jmodel.params}, *args, method=fn)


def test_vision_tower_blip2_form_matches_jax(pair):
    """Every token normalised by the post-LN (and the pooled token 0 of
    them), no pre-LN: the tower's outputs and its hidden states."""
    jmodel, model = pair
    px = _pixels(2)
    jx, jpooled, jhidden = _apply(jmodel, lambda m, p: m.vision_model(
        p, output_hidden_states=True), jnp.asarray(px))
    assert model.vision_model.pre_layrnorm is None
    with torch.inference_mode():
        x, pooled, hidden = model.vision_model(torch.from_numpy(px), output_hidden_states=True)
    _close(jx, x)
    _close(jpooled, pooled)
    assert torch.equal(pooled, x[:, 0])
    assert len(hidden) == len(jhidden)
    for j, t in zip(jhidden, hidden):
        _close(j, t)


def test_qformer_matches_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(2)
    queries = rng.standard_normal((2, 4, 32)).astype(np.float32)
    image = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = _apply(jmodel, lambda m, q, i: m.qformer(q, i), jnp.asarray(queries),
                 jnp.asarray(image))
    with torch.inference_mode():
        out = model.qformer(torch.from_numpy(queries), torch.from_numpy(image))
    _close(ref, out)
    layers = model.qformer.layers
    assert [layer.has_cross for layer in layers] == [i % 2 == 0 for i in range(len(layers))]


def test_encode_image_matches_jax(pair):
    jmodel, model = pair
    px = _pixels(2, seed=3)
    ref = jmodel.encode_image(jnp.asarray(px))
    with torch.inference_mode():
        out = model.encode_image(torch.from_numpy(px))
    assert out.shape == (2, 4, 32)
    _close(ref, out)


def test_forward_logits_match_jax_without_and_over_the_cache(pair):
    """[query features; text] through OPT: the cache-free logits, then the
    prefill over a cache and two decode steps."""
    jmodel, model = pair
    px = _pixels(1, seed=4)
    ids = np.asarray([[2, 5, 9, 30, 71]], np.int32)
    jl, _ = jmodel(jnp.asarray(px), jnp.asarray(ids))
    with torch.inference_mode():
        tl, cache = model(torch.from_numpy(px), torch.from_numpy(ids).long())
    assert cache is None and tl.shape == (1, 4 + 5, 96)
    _close(jl, tl)
    pos = np.arange(9, dtype=np.int32)[None]
    jcache, cache = jmodel.init_cache(1, 12), model.init_cache(1, 12)
    jl, jcache = jmodel(jnp.asarray(px), jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    with torch.inference_mode():
        tl, cache = model(torch.from_numpy(px), torch.from_numpy(ids).long(),
                          torch.from_numpy(pos).long(), cache=cache)
    _close(jl, tl)
    lm = model.language_model
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(2):
        jl, jcache = _apply(jmodel, lambda m, t, p, c: m.language_model(t, p, cache=c),
                            jnp.asarray(tok), jcache.lengths[:, None], jcache)
        with torch.inference_mode():
            tl, cache = lm(torch.from_numpy(tok).long(), cache.lengths[:, None].long(),
                           cache=cache)
        _close(jl, tl)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("eos", [None, -1], ids=["eos_2", "no_eos"])
def test_generate_tokens_equal_jax(pair, eos):
    """A batch of two right-padded prompts (one padded), 6 new tokens: the
    same greedy tokens as the JAX generate. On the CPU no kernel launches."""
    jmodel, model = pair
    px = _pixels(2, seed=5)
    ids = np.asarray([[2, 7, 11, 40], [2, 13, 0, 0]], np.int32)
    mask = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32)
    kw = {} if eos is None else dict(eos_token_id=eos)
    want = np.asarray(jmodel.generate(jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask),
                                      max_new_tokens=6, **kw))
    before = (tnorms.layer_norm.launches, tda.decode_attention.launches)
    got = model.generate(torch.from_numpy(px), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), max_new_tokens=6, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tnorms.layer_norm.launches, tda.decode_attention.launches) == before


def test_generate_default_is_32_new_tokens():
    _, model = _pair(TINY)
    out = model.generate(torch.from_numpy(_pixels(1)), torch.tensor([[2]]), eos_token_id=-1)
    assert out.shape == (1, 32)


def test_configs_refuse_the_unported_branches():
    with pytest.raises(NotImplementedError, match="EVA ViT-g"):
        Blip2Config.from_dict(dict(TINY, vision_tower="eva"))
    with pytest.raises(NotImplementedError, match="FlanT5"):
        Blip2Config.from_dict(dict(TINY, lm_type="t5"))
    vision = Blip2Config.from_dict(TINY).vision
    assert (vision.patch_bias, vision.use_pre_layernorm, vision.post_layernorm_full) == \
        (True, False, True)
    CLIPVisionConfig(use_pre_layernorm=False, post_layernorm_full=True)  # no longer refused


def test_hf_checkpoint_loads_through_from_pretrained(tmp_path):
    """A tiny transformers Blip2ForConditionalGeneration (OPT) saved to a
    directory, as tests/test_blip2.py saves it: the port's from_pretrained
    splits the tower's fused qkv, renames its `projection`, drops the tied
    lm_head; its image features equal HF's own, and its logits the JAX
    package's from the same directory."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.Blip2ForConditionalGeneration(transformers.Blip2Config(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=16, patch_size=8),
        qformer_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=64, cross_attention_frequency=2,
                            encoder_hidden_size=32, vocab_size=30),
        text_config=dict(model_type="opt", vocab_size=96, hidden_size=32, ffn_dim=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=64, word_embed_proj_dim=32),
        num_query_tokens=4)).eval()
    with torch.no_grad():  # norms and biases away from 1 / 0
        for p in hf.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    model = Blip2ForConditionalGeneration.from_pretrained(str(tmp_path), device="cpu")
    px = np.random.RandomState(0).randn(1, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        image_embeds = hf.vision_model(torch.from_numpy(px)).last_hidden_state
        q_out = hf.qformer(query_embeds=hf.query_tokens.expand(1, -1, -1),
                           encoder_hidden_states=image_embeds).last_hidden_state
        hf_feats = hf.language_projection(q_out)
        feats = model.encode_image(torch.from_numpy(np.transpose(px, (0, 2, 3, 1))))
    np.testing.assert_allclose(feats.numpy(), hf_feats.numpy(), atol=1e-5, rtol=1e-4)
    jmodel = JBlip2.from_pretrained(str(tmp_path))
    pxh = np.transpose(px, (0, 2, 3, 1))
    ids = np.asarray([[2, 5, 9]], np.int32)
    jl, _ = jmodel(jnp.asarray(pxh), jnp.asarray(ids))
    with torch.inference_mode():
        tl, _ = model(torch.from_numpy(pxh), torch.from_numpy(ids).long())
    _close(jl, tl)


def test_launch_walk_and_size_at_full_width_on_meta():
    """BLIP-2 OPT-2.7B: 3.74 B parameters; a 32-token caption over the
    1-id prompt launches B10 79 + 31 + 65 x 32 times (the tower, the
    Q-Former, 32 OPT forwards) and B7 32 x 31 times; no flash."""
    with torch.device("meta"):
        model = Blip2ForConditionalGeneration(Blip2Config.from_dict(BLIP2_OPT_2_7B))
    assert 3.7e9 < sum(p.numel() for p in model.parameters()) < 3.8e9
    assert (n_layer_norms(model.vision_model), n_layer_norms(model.qformer),
            n_layer_norms(model.language_model)) == (79, 31, 65)
    assert expected_launches_blip2(model, 1, 32) == {
        "layer_norm": 79 + 31 + 65 * 32, "decode_attention": 32 * 31, "flash_attention": 0}
    assert expected_launches_blip2(model, 1, 1)["decode_attention"] == 0
    # the widths of B10 on the path, each taken by a forward plan; B7's head
    widths = {m.weight.shape[0] for m in model.modules() if isinstance(m, FusedLayerNorm)}
    assert widths == {1408, 768, 2560}
    for rows, h in ((257, 1408), (32, 768), (33, 2560), (1, 2560)):
        assert tnorms.layer_norm_plan(rows, h, 2) is not None
    assert model.config.text.head_dim_ == 80 and 80 in tda._KERNEL_HEAD_DIMS
