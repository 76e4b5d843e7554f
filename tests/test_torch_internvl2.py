"""The port's InternVL2 (paddlemix_tpu_torch.models.internvl2 and
processors.internvl_processing) against the JAX package on shared inputs and
weights, on the CPU: the tiling processor bit for bit (MiniMonkey's too);
InternViT with and without InternViT-6B's qk RMSNorm and RMSNorm layers, at
the table's grid and at another (the bicubic position resize); pixel shuffle
v1 / v2; `extract_feature` at select_layer -1 and -2; the splice; the logits
without and over the cache; greedy tokens against a greedy loop over JAX's
module and its KVCache; the real-tiles-only rule; the wqkv split of the
published checkpoints against JAX's `convert_foreign_state_dict`; the
directories both ways; the faults this slice meets (ROADMAP C.42); and the
launch walk of InternVL2-8B on the meta device.

The tiny model is tests/test_internvl_eva.py's (4 tokens a tile). The JAX
package initialises it, every leaf is then moved by seeded noise (norms and
layer scales off 1 / 0.1), and `core.convert.INTERNVL_KEY_MAP` carries it
over, every key consumed. fp32 throughout: the sides differ by summation
order (flax's norms take the variance as E[x^2] - E[x]^2, the port's plain
B10 two-pass; XLA's dots), inside atol 2e-5, rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.internvl2 import InternVLChatConfig as JConfig
from paddlemix_tpu.models.internvl2 import InternVLChatModel as JModel
from paddlemix_tpu.models.internvl2 import pixel_shuffle as j_pixel_shuffle
from paddlemix_tpu.models.llama.modeling import KVCache as JKVCache
from paddlemix_tpu.processors import internvl_processing as jproc
from paddlemix_tpu_torch.auto import AutoConfig, AutoModel, AutoProcessor
from paddlemix_tpu_torch.core import INTERNVL_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.internvl2 import (
    INTERNVL2_8B,
    InternVLChatConfig,
    InternVLChatModel,
    convert_hf_state_dict,
    expected_launches_internvl2,
    pixel_shuffle,
)
from paddlemix_tpu_torch.processors import internvl_processing as tproc

pytestmark = pytest.mark.torch_port

VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
              image_size=32, patch_size=8)
TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            eos_token_id=2)
TINY = dict(vision_config=VISION, llm_config=TEXT, img_context_token_id=120,
            downsample_ratio=0.5)
SIX_B = dict(TINY, vision_config=dict(VISION, qk_normalization=True, norm_type="rms_norm"),
             select_layer=-2, ps_version="v1")
ATOL, RTOL = 2e-5, 1e-4


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(np.asarray(v, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32))
         for k, v in flat.items()})


def _pair(cfg_dict):
    jmodel = JModel.from_config(JConfig.from_dict(cfg_dict), seed=0)
    jmodel = JModel(jmodel.config, params=_noisy(jmodel.params, 1))
    model = InternVLChatModel(InternVLChatConfig.from_dict(cfg_dict)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   INTERNVL_KEY_MAP))
    return jmodel, model


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY)


@pytest.fixture(scope="module")
def pair6b():
    return _pair(SIX_B)


def _close(ref, out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _tiles(n, size=32, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _prompt(n_tiles, text_len=4, seed=0, tokens=4):
    rs = np.random.RandomState(seed)
    ids = [5] + [120] * (tokens * n_tiles) + [6] + list(rs.randint(7, 110, text_len))
    return np.asarray([ids], np.int64)


# ------------------------------------------------------------- processor
@pytest.mark.parametrize("hw", [(64, 128), (300, 200), (448, 448), (768, 1024), (50, 900),
                                (1000, 30)])
def test_tiling_equals_jax(hw):
    """The grid choice and every tile, thumbnail included, bit for bit; the
    complementary grid and MiniMonkey's order too."""
    img = _image(*hw, hw[0])
    rs = sorted({(i, j) for n in range(1, 13) for i in range(1, n + 1)
                 for j in range(1, n + 1) if i * j <= 12}, key=lambda x: x[0] * x[1])
    assert tproc.find_closest_aspect_ratio(hw[1] / hw[0], rs, hw[1], hw[0], 448) == \
        jproc.find_closest_aspect_ratio(hw[1] / hw[0], rs, hw[1], hw[0], 448)
    for fn, kw in ((tproc.dynamic_preprocess, dict(image_size=64, max_num=6)),
                   (tproc.dynamic_preprocess2, dict(image_size=64, prior_aspect_ratio=(2, 3))),
                   (tproc.minimonkey_preprocess, dict(image_size=64))):
        out = fn(img, **kw)
        ref = getattr(jproc, fn.__name__)(img, **kw)
        assert len(out) == len(ref)
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("multi_scale", [False, True], ids=["dynamic", "minimonkey"])
def test_image_processor_equals_jax(multi_scale):
    """pixel_values, tile_mask and num_tiles bit for bit, over two images of
    other aspect ratios; pixel_unshuffle of features too."""
    images = [_image(96, 200, 0), _image(150, 70, 1)]
    kw = dict(image_size=32, max_num=6, pad_to_tiles=9, multi_scale=multi_scale)
    out = tproc.InternVLImageProcessor(**kw)(images)
    ref = jproc.InternVLImageProcessor(**kw)(images)
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype and np.array_equal(out[key], ref[key]), key
    assert (out["tile_mask"].sum(1) == np.minimum(out["num_tiles"], 9)).all()
    feats = np.random.RandomState(0).randn(2, 8, 6, 5).astype(np.float32)
    assert np.array_equal(tproc.pixel_unshuffle(feats), jproc.pixel_unshuffle(feats))
    assert tproc.InternVLImageProcessor.from_dict(tproc.InternVLImageProcessor(**kw).to_dict()) \
        == tproc.InternVLImageProcessor(**kw)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_pixel_shuffle_equals_jax(version):
    x = np.random.RandomState(1).randn(3, 4, 6, 5).astype(np.float32)
    out = pixel_shuffle(torch.from_numpy(x), 0.5, version)
    assert out.shape == (3, 2, 3, 20)
    assert np.array_equal(out.numpy(), np.asarray(j_pixel_shuffle(jnp.asarray(x), 0.5, version)))


@pytest.mark.parametrize("variant", ["300m", "6b"])
@pytest.mark.parametrize("size", [32, 48], ids=["table_grid", "bicubic_grid"])
def test_tower_matches_jax(pair, pair6b, variant, size):
    """The tower's last hidden state and class row: InternViT-300M's form and
    the 6B form (qk RMSNorm over the flattened heads, RMSNorm layers), at the
    table's 4 x 4 grid and at 6 x 6 (the table resized bicubically)."""
    jmodel, model = pair if variant == "300m" else pair6b
    x = _tiles(3, size, seed=size)
    ref, ref_cls, _ = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(x),
                                          method=lambda m, p: m.vision_model(p))
    with torch.inference_mode():
        out, cls, _ = model.vision_model(torch.from_numpy(x))
    assert out.shape == (3, (size // 8) ** 2 + 1, 32)
    _close(ref, out)
    _close(ref_cls, cls)


def test_qkv_views_are_read_in_place(pair):
    """q, k and v reach attention as strided views of the one projection
    (global thirds, (B, N, 3, H, D)): no copy."""
    _, model = pair
    attn = model.vision_model.layers[0].attn
    x = torch.randn(2, 17, 32)
    q, k, v = attn.split_qkv(x)
    assert q.shape == (2, 17, 2, 16)
    assert q.stride() == k.stride() == v.stride() == (17 * 96, 96, 16, 1)
    assert k.data_ptr() - q.data_ptr() == 32 * 4 and v.data_ptr() - k.data_ptr() == 32 * 4


@pytest.mark.parametrize("variant", ["300m", "6b"])
def test_extract_feature_matches_jax(pair, pair6b, variant):
    """select_layer -1 (every layer) and -2 (the 6B form's: one layer fewer
    runs), the class token dropped, unshuffled v2 / v1, mlp1."""
    jmodel, model = pair if variant == "300m" else pair6b
    x = _tiles(3)
    ref = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(x),
                              method=lambda m, p: m.extract_feature(p))
    with torch.inference_mode():
        out = model.extract_feature(x)
    assert out.shape == (3, 4, 32)
    _close(ref, out)


def test_real_tiles_only_equal_jax_on_the_padded_stack(pair):
    """The processor's padded stack: the port runs the tower on the tiles the
    mask marks alone, and their features equal JAX's first rows on the whole
    stack; the spliced logits equal JAX's on the padded stack."""
    jmodel, model = pair
    enc = tproc.InternVLImageProcessor(image_size=32, max_num=4, pad_to_tiles=5)(
        [_image(64, 128, 0)])
    n = int(enc["num_tiles"][0])
    assert n == 3 and enc["tile_mask"][0].tolist() == [1, 1, 1, 0, 0]
    params = {"params": jmodel.params}
    ref = jmodel.module.apply(params, jnp.asarray(enc["pixel_values"][0]),
                              method=lambda m, p: m.extract_feature(p))
    with torch.inference_mode():
        out = model.extract_feature(enc["pixel_values"], enc["tile_mask"])
    assert out.shape == (n, 4, 32)
    _close(np.asarray(ref)[:n], out)
    ids = _prompt(n)
    jref, _ = jmodel.module.apply(params, jnp.asarray(ids.astype(np.int32)),
                                  jnp.asarray(enc["pixel_values"][0]))
    with torch.inference_mode():
        logits, _ = model(ids, enc["pixel_values"], tile_mask=enc["tile_mask"])
    _close(jref, logits)


def test_splice_matches_jax(pair):
    """A batch of 2 reads the one feature set, as JAX broadcasts it."""
    jmodel, model = pair
    ids = np.asarray([[5, 120, 120, 7, 120, 9], [120, 1, 2, 120, 4, 5]])
    feats = np.random.RandomState(3).randn(2, 2, 32).astype(np.float32)
    ref = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(ids), jnp.asarray(feats),
                              method=lambda m, i, f: m.splice(i, f))
    with torch.inference_mode():
        out = model.splice(torch.from_numpy(ids), torch.from_numpy(feats))
    assert torch.equal(out[1, 3], torch.from_numpy(feats[0, 1]))
    _close(ref, out, 0, 0)


def test_forward_logits_match_jax_without_and_over_the_cache(pair):
    """Two tiles spliced in: the cache-free forward, the prefill over the
    cache, then one decode step."""
    jmodel, model = pair
    x, ids = _tiles(2), _prompt(2)
    s = ids.shape[1]
    params = {"params": jmodel.params}
    jids = jnp.asarray(ids.astype(np.int32))
    ref, _ = jmodel.module.apply(params, jids, jnp.asarray(x))
    with torch.inference_mode():
        out, _ = model(ids, x)
    _close(ref, out)
    jcache = JKVCache.create(jmodel.config.text, 1, s + 2, jnp.float32)
    ref, jcache = jmodel.module.apply(params, jids, jnp.asarray(x), cache=jcache)
    cache = model.init_cache(1, s + 2)
    with torch.inference_mode():
        out, cache = model(ids, x, cache=cache)
    _close(ref, out)
    ref, _ = jmodel.module.apply(params, jnp.asarray([[7]]), None, jcache.lengths[:, None],
                                 cache=jcache)
    with torch.inference_mode():
        out, _ = model(torch.tensor([[7]]), None, cache.lengths[:, None], cache=cache)
    _close(ref, out)


def _jax_greedy(jmodel, ids, x, new_tokens):
    params = {"params": jmodel.params}
    cache = JKVCache.create(jmodel.config.text, 1, ids.shape[1] + new_tokens, jnp.float32)
    logits, cache = jmodel.module.apply(params, jnp.asarray(ids.astype(np.int32)),
                                        jnp.asarray(x), cache=cache)
    toks = [int(jnp.argmax(logits[0, -1]))]
    for _ in range(new_tokens - 1):
        logits, cache = jmodel.module.apply(params, jnp.asarray([[toks[-1]]]), None,
                                            cache.lengths[:, None], cache=cache)
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks


@pytest.mark.parametrize("variant", ["300m", "6b"])
def test_greedy_tokens_equal_a_jax_greedy_loop(pair, pair6b, variant):
    jmodel, model = pair if variant == "300m" else pair6b
    x, ids = _tiles(2, seed=4), _prompt(2, text_len=5, seed=4)
    n = 8
    out = model.generate(ids, x, max_new_tokens=n, eos_token_id=-1)
    assert out.shape == (1, n) and out.dtype == torch.int32
    assert out[0].tolist() == _jax_greedy(jmodel, ids, x, n)


# ------------------------------------------------------------ checkpoints
def _hf_flat(model):
    """The tiny model's weights under the published InternVL2 names, with
    InternLM2's grouped wqkv (per KV group: its q heads, then k, then v)."""
    t = model.config.text
    g, hd = t.num_attention_heads // t.kv_heads, t.head_dim_
    out = {}
    for k, v in model.state_dict().items():
        k = k.replace("vision_model.layers.", "vision_model.encoder.layers.")
        for name in ("patch_embedding", "class_embedding", "position_embedding"):
            k = k.replace(f"vision_model.{name}", f"vision_model.embeddings.{name}")
        for a, b in (("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            k = k.replace(f".{a}.", f".{b}.")
        k = k.replace("mlp1_ln.", "mlp1.0.").replace("mlp1_fc1.", "mlp1.1.") \
            .replace("mlp1_fc2.", "mlp1.3.")
        k = k.replace("language_model.lm_head.", "language_model.output.")
        k = k.replace("embed_tokens", "tok_embeddings").replace(".self_attn.o_proj.",
                                                                 ".attention.wo.")
        k = k.replace(".mlp.gate_proj.", ".feed_forward.w1.").replace(
            ".mlp.up_proj.", ".feed_forward.w3.").replace(".mlp.down_proj.", ".feed_forward.w2.")
        k = k.replace(".input_layernorm.", ".attention_norm.").replace(
            ".post_attention_layernorm.", ".ffn_norm.")
        out[k] = v
    for i in range(t.num_hidden_layers):
        p = f"language_model.model.layers.{i}"
        q, kk, vv = (out.pop(f"{p}.self_attn.{n}_proj.weight") for n in "qkv")
        w = torch.cat([q.view(t.kv_heads, g, hd, -1), kk.view(t.kv_heads, 1, hd, -1),
                       vv.view(t.kv_heads, 1, hd, -1)], dim=1)
        out[f"{p}.attention.wqkv.weight"] = w.reshape(-1, w.shape[-1])
    return out


def test_wqkv_split_equals_jax_and_the_lm_head_is_read(pair):
    """The published keys (grouped wqkv, InternLM2's names, `mlp1.N`): the
    port's `convert_hf_state_dict` gives every key JAX's
    `convert_foreign_state_dict` gives, bit for bit, and reads them back into
    the model exactly; JAX maps InternLM2's `output` (the lm_head) to a key
    no parameter has (C.42), the port reads it."""
    _, model = pair
    flat = _hf_flat(model)
    assert "language_model.model.layers.0.attention.wqkv.weight" in flat
    out = convert_hf_state_dict(flat, model.config)
    ref = JModel.convert_foreign_state_dict({k: v.numpy() for k, v in flat.items()},
                                            JConfig.from_dict(TINY))
    assert set(ref) - set(out) == {"SKIP.lm_head"}
    assert set(out) - set(ref) == {"language_model.lm_head.kernel"}
    for k in set(ref) & set(out):
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k
    back = flax_to_torch_state_dict(out, model, INTERNVL_KEY_MAP)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_directories_both_ways(pair, tmp_path):
    """The port's save_pretrained read back by the port, by AutoModel and by
    JAX; JAX's save_pretrained read by the port: 0 tensors differing. A
    directory of the published keys is read through `convert_hf_state_dict`."""
    jmodel, model = pair
    model.save_pretrained(str(tmp_path / "port"), max_shard_bytes=50_000)
    back = InternVLChatModel.from_pretrained(str(tmp_path / "port"), device="cpu")
    auto = AutoModel.from_pretrained(str(tmp_path / "port"), device="cpu")
    jback = JModel.from_pretrained(str(tmp_path / "port"))
    jref = flax_to_torch_state_dict(flatten_params(jback.params), model, INTERNVL_KEY_MAP)
    assert type(AutoConfig.from_pretrained(str(tmp_path / "port"))).__name__ == \
        "InternVLChatConfig"
    jmodel.save_pretrained(str(tmp_path / "jax"))
    from_jax = InternVLChatModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for k, v in model.state_dict().items():
        for other in (back, auto, from_jax):
            assert torch.equal(other.state_dict()[k], v), k
        assert torch.equal(jref[k], v), k
    from paddlemix_tpu_torch.core.modeling import save_state_dict

    model.config.save_pretrained(str(tmp_path / "hf"))
    save_state_dict(_hf_flat(model), str(tmp_path / "hf"))
    hf = InternVLChatModel.from_pretrained(str(tmp_path / "hf"), device="cpu",
                                           dtype=torch.bfloat16)
    for k, v in model.state_dict().items():
        got = hf.state_dict()[k]
        assert got.dtype == (torch.float32 if "norm" in k or "mlp1_ln" in k
                             else torch.bfloat16), k
        assert torch.equal(got, v.to(got.dtype)), k
    tproc.InternVLImageProcessor(image_size=32).save_pretrained(str(tmp_path / "port"))
    assert AutoProcessor.from_pretrained(str(tmp_path / "port")) == \
        tproc.InternVLImageProcessor(image_size=32)


def test_fault42_default_image_context_id_lies_past_the_vocab(pair):
    """ROADMAP C.42: JAX's default img_context_token_id, 151,667, lies past
    InternVL2-8B's vocab of 92,553 (the published chat code takes the
    tokenizer's <IMG_CONTEXT>, 92,546; the port's full-width config passes
    it). JAX's embedding of an id past its table is NaN (jnp.take's fill),
    which its splice then replaces: a prompt of the default id still gets
    its features, and the port (which looks placeholders up as id 0) gives
    the same logits. A prompt of the published id under the default config
    gets no features on either side."""
    jmodel, model = pair
    assert JConfig().img_context_token_id == InternVLChatConfig().img_context_token_id == 151667
    assert InternVLChatConfig().img_context_token_id >= INTERNVL2_8B["llm_config"]["vocab_size"]
    assert InternVLChatConfig.from_dict(INTERNVL2_8B).img_context_token_id == 92546
    emb = jmodel.module.apply({"params": jmodel.params}, jnp.asarray([[200]]),
                              method=lambda m, i: m.language_model.embed(i))
    assert bool(jnp.isnan(emb).all())
    cfg = dict(TINY, img_context_token_id=200)
    jbig = JModel(JConfig.from_dict(cfg), params=jmodel.params)
    big = InternVLChatModel(InternVLChatConfig.from_dict(cfg)).eval()
    big.load_state_dict(model.state_dict())
    x, ids = _tiles(1), np.asarray([[5, 200, 200, 200, 200, 6, 9]])
    ref, _ = jbig(jnp.asarray(ids.astype(np.int32)), jnp.asarray(x))
    with torch.inference_mode():
        out, _ = big(ids, x)
    assert bool(jnp.isfinite(ref).all())
    _close(ref, out)
    with torch.inference_mode():  # the tiny config's id 120 is in the vocab: no image read
        plain, _ = model(np.asarray([[5, 100, 6, 9]]), None)
        same, _ = big(np.asarray([[5, 100, 6, 9]]), x)
    assert torch.equal(plain, same)


# ------------------------------------------------------------ full width
def test_full_width_config_and_launch_walk():
    """InternVL2-8B at its published widths on the meta device: 8.08 B
    parameters, 256 tokens a tile; the walk of a 12-tile + thumbnail request
    (24 layers x 2 + the projector's B10, 24 B1 at (13, 1025, 16, 64), 65
    B11 and 32 B7 a token)."""
    cfg = InternVLChatConfig.from_dict(INTERNVL2_8B)
    with torch.device("meta"):
        model = InternVLChatModel(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert 8.0e9 < n < 8.15e9 and cfg.tokens_per_tile == 256
    assert cfg.text.kv_heads == 8 and cfg.text.vocab_size == 92553
    walk = expected_launches_internvl2(model, 3400, 128, tiles=13)
    assert walk == {"rms_norm": 65 * 128, "decode_attention": 32 * 127, "layer_norm": 49,
                    "flash_attention": 24}
    assert expected_launches_internvl2(model, 40, 128)["layer_norm"] == 0
