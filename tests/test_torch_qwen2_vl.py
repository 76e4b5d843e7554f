"""The port's Qwen2-VL (paddlemix_tpu_torch.models.qwen2_vl and
processors.qwen2_vl_processing) against the JAX package on shared inputs and
weights, on the CPU: the processor's functions and `get_rope_index` bit for
bit; M-RoPE and the vision rope; the vision tower, `splice` and the logits
(without and over the cache) in fp32; greedy `generate` against the JAX
module stepped at explicit positions; `from_pretrained` of an HF directory
written by transformers, read by both packages alike; `save_pretrained`
round trips; the faults of the reference this slice meets (ROADMAP C.16-C.21);
and the launch walk of Qwen2-VL-7B at full width on the meta device.

The tiny model is tests/test_qwen2_vl.py's TINY (mrope sections (4, 4, 4)).
The JAX package initialises it, every leaf is then moved by seeded noise (so
that norms and biases are not 1 / 0), and `core.convert.QWEN2_VL_KEY_MAP`
carries it over, every key consumed. fp32 throughout: the two sides differ
by summation order (flax's LayerNorm takes the variance as E[x^2] - E[x]^2,
the port's plain B10 two-pass; XLA's dots), inside atol 2e-5, rtol 1e-4.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from PIL import Image

from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama.modeling import KVCache as JKVCache
from paddlemix_tpu.models.qwen2_vl import Qwen2VLConfig as JConfig
from paddlemix_tpu.models.qwen2_vl import Qwen2VLForConditionalGeneration as JQwen2VL
from paddlemix_tpu.models.qwen2_vl import get_rope_index as j_get_rope_index
from paddlemix_tpu.ops import rope as jrope
from paddlemix_tpu.processors import qwen2_vl_processing as jproc
from paddlemix_tpu_torch.auto import AutoConfig, AutoModel
from paddlemix_tpu_torch.core import QWEN2_VL_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.core.modeling import save_state_dict
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlemix_tpu_torch.models.qwen2_vl import (
    QWEN2_VL_7B,
    Qwen2VisionTransformer,
    Qwen2VLConfig,
    Qwen2VLForConditionalGeneration,
    convert_hf_state_dict,
    expected_launches_qwen2_vl,
    get_rope_index,
    hf_state_dict,
    prompt_ids,
)
from paddlemix_tpu_torch.ops import rope as trope
from paddlemix_tpu_torch.processors import Qwen2VLImageProcessor, Qwen2VLProcessor
from paddlemix_tpu_torch.processors import qwen2_vl_processing as tproc

pytestmark = pytest.mark.torch_port

TINY = dict(
    vision_config=dict(depth=2, embed_dim=32, num_heads=2, patch_size=4,
                       spatial_merge_size=2, temporal_patch_size=2, hidden_size=48,
                       mlp_ratio=2.0),
    text_config=dict(vocab_size=160, hidden_size=48, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                     max_position_embeddings=128, eos_token_id=2),
    image_token_id=150, video_token_id=151, vision_start_token_id=149,
    mrope_section=(4, 4, 4),
)
VISION_END = 148
PROC = dict(patch_size=4, merge_size=2, temporal_patch_size=2, min_pixels=8 * 8,
            max_pixels=64 * 64, pad_to_multiple=32)
ATOL, RTOL = 2e-5, 1e-4


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(np.asarray(v, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32))
         for k, v in flat.items()})


@pytest.fixture(scope="module")
def pair():
    jmodel = JQwen2VL.from_config(JConfig.from_dict(TINY), seed=0)
    jmodel = JQwen2VL(jmodel.config, params=_noisy(jmodel.params, 1))
    model = Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_dict(TINY)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   QWEN2_VL_KEY_MAP))
    return jmodel, model


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _request(images, text_len=4, seed=0):
    """The processor's outputs for `images` (both packages' processors) and
    a prompt: each image's placeholders between vision start / end ids,
    then `text_len` ids."""
    enc = tproc.Qwen2VLImageProcessor(**PROC)(images)
    ids = []
    for g in enc["image_grid_thw"]:
        ids += [149] + [150] * (int(np.prod(g)) // 4) + [VISION_END]
    ids += list(np.random.RandomState(seed).randint(0, 140, text_len))
    ids = np.asarray([ids], np.int64)
    pos = get_rope_index(ids, enc["image_grid_thw"], 150, 151, 2)
    return enc, ids, pos


def _close(ref, out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------- processor
@pytest.mark.parametrize("hw,factor", [((300, 500), 28), ((10, 10), 28), ((720, 1280), 28),
                                       ((480, 640), 28), ((360, 640), 28), ((4000, 3000), 28),
                                       ((17, 3000), 28), ((16, 24), 8)])
def test_smart_resize_equals_jax(hw, factor):
    assert tproc.smart_resize(*hw, factor=factor) == jproc.smart_resize(*hw, factor=factor)
    with pytest.raises(ValueError, match="aspect ratio"):
        tproc.smart_resize(10, 4000)


@pytest.mark.parametrize("total,fps,video_fps", [(240, 2.0, 30.0), (300, 2.0, 30.0),
                                                 (3, 2.0, 30.0), (100000, 2.0, 30.0),
                                                 (61, 1.0, 24.0)])
def test_smart_nframes_equals_jax(total, fps, video_fps):
    assert tproc.smart_nframes(total, fps, video_fps) == jproc.smart_nframes(total, fps,
                                                                             video_fps)
    assert tproc.smart_nframes(240, 2.0, 30.0) == 16  # the smoke's 8 s clip at 30 fps


@pytest.mark.parametrize("shape", [(16, 24, 3), (5, 16, 24, 3), (4, 8, 8, 3)])
def test_extract_patches_and_positions_equal_jax(shape):
    """An image, a 5-frame video (padded to 6 by its last frame) and a
    4-frame one: patches and grids bit for bit, and the (h, w) positions."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    p, grid = tproc.extract_patches(x, patch_size=4, merge_size=2, temporal_patch_size=2)
    jp, jgrid = jproc.extract_patches(x, patch_size=4, merge_size=2, temporal_patch_size=2)
    assert grid == jgrid and p.dtype == jp.dtype and np.array_equal(p, jp)
    grids = [grid, (1, 4, 6)]
    assert np.array_equal(tproc.vision_patch_positions(grids, 2),
                          jproc.vision_patch_positions(grids, 2))


@pytest.mark.parametrize("sizes", [[(16, 16)], [(16, 24), (20, 12)], [(30, 70)]])
def test_image_processor_equals_jax(sizes):
    """Patches, positions, segments (image i is i + 1, pads 0), grids and the
    count, bit for bit, from numpy images and from a decoded jpeg."""
    images = [_image(h, w, i) for i, (h, w) in enumerate(sizes)]
    buf = io.BytesIO()
    Image.fromarray(images[0]).save(buf, format="JPEG")
    images[0] = Image.open(io.BytesIO(buf.getvalue()))
    out = tproc.Qwen2VLImageProcessor(**PROC)(images)
    ref = jproc.Qwen2VLImageProcessor(**PROC)(images)
    assert set(out) == set(ref)
    for key in ref:
        assert np.asarray(out[key]).dtype == np.asarray(ref[key]).dtype, key
        assert np.array_equal(out[key], ref[key]), key
    assert out["pixel_patches"].shape[1] % 32 == 0
    assert set(np.unique(out["patch_segments"])) <= set(range(len(sizes) + 1))
    placeholders = Qwen2VLProcessor(tproc.Qwen2VLImageProcessor(**PROC))("", images)
    assert placeholders["num_image_tokens"] == jproc.Qwen2VLProcessor(
        jproc.Qwen2VLImageProcessor(**PROC))("", images)["num_image_tokens"]
    # the processor round-trips its config
    assert Qwen2VLImageProcessor.from_dict(Qwen2VLImageProcessor(**PROC).to_dict()) == \
        Qwen2VLImageProcessor(**PROC)


@pytest.mark.parametrize("case", ["image", "two_images", "video", "padding", "text"])
def test_get_rope_index_equals_jax(case):
    ids = np.asarray([[5, 149, 150, 150, 150, 150, 148, 9, 11]])
    grid = np.asarray([[1, 4, 4]])
    mask = None
    if case == "two_images":
        ids = np.asarray([[5, 149, 150, 150, 148, 149, 150, 150, 150, 150, 150, 150, 148, 7]])
        grid = np.asarray([[1, 2, 4], [1, 4, 6]])
    elif case == "video":
        ids = np.asarray([[5, 149] + [151] * 12 + [148, 9]])
        grid = np.asarray([[3, 4, 4]])
    elif case == "padding":
        ids = np.concatenate([ids, ids[:, :3]], axis=1)
        mask = np.ones_like(ids)
        mask[:, -3:] = 0
    elif case == "text":
        ids, grid = np.asarray([[5, 6, 7], [8, 9, 10]]), None
    out = get_rope_index(ids, grid, 150, 151, 2, attention_mask=mask)
    ref = j_get_rope_index(ids, grid, 150, 151, 2, attention_mask=mask)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    if case == "video":  # t advances a temporal group
        assert out[0, 0, 2:14].tolist() == [2] * 4 + [3] * 4 + [4] * 4


def test_mrope_and_vision_rope_match_jax():
    """M-RoPE over three streams and the tower's (h, w) tables, within 1e-6
    (fp32 cos / sin of the same angles); with equal streams M-RoPE is the
    plain rope bit for bit (the decode steps')."""
    rs = np.random.RandomState(0)
    pos = rs.randint(0, 3000, (3, 2, 9))
    cos, sin = trope.mrope_cos_sin(torch.from_numpy(pos), 128, (16, 24, 24), 1e6)
    jcos, jsin = jrope.mrope_cos_sin(jnp.asarray(pos), 128, (16, 24, 24), 1e6)
    assert cos.shape == (2, 9, 128)
    _close(jcos, cos, 1e-6, 0)
    _close(jsin, sin, 1e-6, 0)
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())
    mc, ms = trope.mrope_cos_sin(same, 128, (16, 24, 24), 1e6)
    rc, rsin = trope.rope_cos_sin(same[0], 128, 1e6)
    assert torch.equal(mc, rc) and torch.equal(ms, rsin)
    hw = rs.randint(0, 100, (1, 50, 2))
    cos, sin = trope.rope_cos_sin_hw(torch.from_numpy(hw), 80)
    half = 40
    jh = jrope.rope_cos_sin(jnp.asarray(hw[..., 0]), half)
    jw = jrope.rope_cos_sin(jnp.asarray(hw[..., 1]), half)
    q = half // 2
    for t, (hh, ww) in zip((cos, sin), zip(jh, jw)):
        ref = np.concatenate([hh[..., :q], ww[..., :q], hh[..., :q], ww[..., :q]], axis=-1)
        _close(ref, t, 1e-6, 0)


# ------------------------------------------------------------------ model
def _vision_args(enc):
    return tuple(enc[k] for k in ("pixel_patches", "patch_pos_hw", "patch_segments"))


def test_vision_tower_matches_jax(pair):
    """Two images in two segments and 16 pad rows (segment 0): every merged
    row, pads included (pads attend among themselves on both sides)."""
    jmodel, model = pair
    enc = tproc.Qwen2VLImageProcessor(**PROC)([_image(16, 24, 0), _image(20, 12, 1)])
    assert (enc["patch_segments"] == 0).sum() > 0
    ref = jmodel.module.apply({"params": jmodel.params}, *map(jnp.asarray, _vision_args(enc)),
                              method=lambda m, *a: m.encode_images(*a))
    with torch.inference_mode():
        out = model.encode_images(*_vision_args(enc))
    assert out.shape == (1, enc["pixel_patches"].shape[1] // 4, 48)
    _close(ref, out)


def test_splice_matches_jax(pair):
    jmodel, model = pair
    rs = np.random.RandomState(3)
    ids = np.asarray([[5, 150, 150, 7, 151, 150, 9], [150, 1, 2, 3, 150, 4, 5]])
    feats = rs.randn(1, 5, 48).astype(np.float32)
    ref = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(ids), jnp.asarray(feats),
                              method=lambda m, i, f: m.splice(i, f))
    with torch.inference_mode():
        out = model.splice(torch.from_numpy(ids), torch.from_numpy(feats))
    assert torch.equal(out[0, 1], torch.from_numpy(feats[0, 0]))
    assert torch.equal(out[1, 4], torch.from_numpy(feats[0, 1]))
    _close(ref, out, 0, 0)


def test_forward_logits_match_jax_without_and_over_the_cache(pair):
    """The cache-free forward (causal) and the prefill over the cache with
    two images spliced in under M-RoPE; then one decode step at explicit
    positions."""
    jmodel, model = pair
    enc, ids, pos = _request([_image(16, 24, 0), _image(12, 20, 1)])
    s = ids.shape[1]
    jargs = (jnp.asarray(ids.astype(np.int32)), jnp.asarray(pos.astype(np.int32)),
             *map(jnp.asarray, _vision_args(enc)))
    ref, _ = jmodel(*jargs)
    with torch.inference_mode():
        out, _ = model(ids, pos, *_vision_args(enc))
    _close(ref, out)

    params = {"params": jmodel.params}
    jcache = JKVCache.create(jmodel.config.text, 1, s + 2, jnp.float32)
    positions = jnp.arange(s)[None]
    ref, jcache = jmodel.module.apply(params, *jargs, cache=jcache, positions=positions)
    cache = model.init_cache(1, s + 2)
    with torch.inference_mode():
        out, cache = model(ids, pos, *_vision_args(enc), cache=cache,
                           positions=torch.arange(s)[None])
    _close(ref, out)
    step_pos = np.full((3, 1, 1), pos.max() + 1)
    ref, _ = jmodel.module.apply(params, jnp.asarray([[7]]), jnp.asarray(step_pos), None, None,
                                 None, cache=jcache, positions=jcache.lengths[:, None])
    with torch.inference_mode():
        out, _ = model(torch.tensor([[7]]), step_pos, cache=cache,
                       positions=cache.lengths[:, None])
    _close(ref, out)


def _jax_steps(jmodel, ids, pos, enc, new_tokens, offset):
    """JAX's module stepped greedily at explicit positions: the prefill
    under M-RoPE, then decode step i at rope position max(pos) + offset + i."""
    params = {"params": jmodel.params}
    s = ids.shape[1]
    cache = JKVCache.create(jmodel.config.text, 1, s + new_tokens, jnp.float32)
    logits, cache = jmodel.module.apply(params, jnp.asarray(ids.astype(np.int32)),
                                        jnp.asarray(pos.astype(np.int32)),
                                        *map(jnp.asarray, _vision_args(enc)), cache=cache,
                                        positions=jnp.arange(s)[None])
    toks = [int(jnp.argmax(logits[0, -1]))]
    for i in range(new_tokens - 1):
        p3 = jnp.full((3, 1, 1), int(pos.max()) + offset + i)
        logits, cache = jmodel.module.apply(params, jnp.asarray([[toks[-1]]]), p3, None, None,
                                            None, cache=cache, positions=cache.lengths[:, None])
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks


def test_generate_equals_jax_module_at_max_plus_one(pair):
    """ROADMAP C.17: the port's greedy tokens equal the JAX module stepped
    with the first decoded token at M-RoPE position max + 1; JAX's own
    `generate` equals the same steps at max + 2, which differ."""
    jmodel, model = pair
    enc, ids, pos = _request([_image(16, 24, 0), _image(12, 20, 1)], text_len=5)
    n = 8
    out = model.generate(ids, pos, *_vision_args(enc), max_new_tokens=n, eos_token_id=-1)
    assert out.shape == (1, n) and out.dtype == torch.int32
    at_plus_one = _jax_steps(jmodel, ids, pos, enc, n, 1)
    at_plus_two = _jax_steps(jmodel, ids, pos, enc, n, 2)
    assert out[0].tolist() == at_plus_one
    assert at_plus_one != at_plus_two
    jout = jmodel.generate(ids.astype(np.int32), jnp.asarray(pos.astype(np.int32)),
                           *map(jnp.asarray, _vision_args(enc)), max_new_tokens=n)
    assert np.asarray(jout)[0].tolist() == at_plus_two


def test_generate_sampling_and_text_only(pair):
    """Sampling draws from the given generator (the same seed, the same
    tokens); a text-only prompt runs the language model alone."""
    _, model = pair
    enc, ids, pos = _request([_image(16, 16, 0)])
    from paddlemix_tpu_torch.models.llama import SamplingConfig

    cfg = SamplingConfig(temperature=0.8, top_k=20, do_sample=True)
    a, b = (model.generate(ids, pos, *_vision_args(enc), max_new_tokens=5, sampling=cfg,
                           generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a, b)
    text = model.generate(torch.tensor([[5, 6, 7]]), max_new_tokens=3, eos_token_id=-1)
    assert text.shape == (1, 3)


# ------------------------------------------------------------ checkpoints
HF_TINY = dict(vision_config=dict(depth=2, embed_dim=32, num_heads=2, patch_size=4,
                                  spatial_merge_size=2, temporal_patch_size=2, hidden_size=256,
                                  mlp_ratio=2.0, in_channels=3, hidden_act="gelu"),
               vocab_size=160, hidden_size=256, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
               rope_theta=1000000.0, image_token_id=150, video_token_id=151,
               vision_start_token_id=149, vision_end_token_id=148,
               rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
               tie_word_embeddings=False)


def _hf_model(**overrides):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Qwen2VLConfig(**dict(HF_TINY, **overrides))
    hf = transformers.Qwen2VLForConditionalGeneration(cfg).eval()
    with torch.no_grad():  # out of the init's small scale, so that errors show
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return hf


def test_hf_checkpoint_reads_alike_in_jax_and_the_port(tmp_path):
    """A checkpoint transformers writes (head_dim 128, so that the published
    (16, 24, 24) sections apply; GQA 2 on 1; the vision MLP's gelu exact):
    the port's `from_pretrained` and JAX's read the same weights (whose
    logits the other tests hold equal), and the port's logits equal
    transformers' on an image prompt; the port's `get_rope_index` equals
    transformers'."""
    hf = _hf_model()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    model = Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path), device="cpu")
    assert model.config.mrope_section == (16, 24, 24) and model.config.text.kv_heads == 1
    jmodel = JQwen2VL.from_pretrained(str(tmp_path))
    ref = flax_to_torch_state_dict(flatten_params(jmodel.params), model, QWEN2_VL_KEY_MAP)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    enc = tproc.Qwen2VLImageProcessor(**dict(PROC, pad_to_multiple=4))([_image(16, 24, 0)])
    n = int(np.prod(enc["image_grid_thw"][0])) // 4
    ids = np.asarray([[5, 149] + [150] * n + [148, 9, 11]])
    pos = get_rope_index(ids, enc["image_grid_thw"], 150, 151, 2)
    hf_pos, _ = hf.model.get_rope_index(torch.from_numpy(ids),
                                        torch.from_numpy(enc["image_grid_thw"]))
    assert np.array_equal(pos, hf_pos.numpy())
    with torch.inference_mode():
        hf_logits = hf(input_ids=torch.from_numpy(ids),
                       pixel_values=torch.from_numpy(enc["pixel_patches"][0]),
                       image_grid_thw=torch.from_numpy(enc["image_grid_thw"])).logits
        out, _ = model(ids, pos, *_vision_args(enc))
    _close(hf_logits, out, 1e-4, 1e-4)
    # AutoModel / AutoConfig know the directory's model_type
    assert type(AutoConfig.from_pretrained(str(tmp_path))).__name__ == "Qwen2VLConfig"
    auto = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert torch.equal(auto.visual.patch_embed.weight, model.visual.patch_embed.weight)


def _legacy(key):
    """transformers' module names -> the names its checkpoints are saved
    under (the published layout)."""
    return key.replace("model.language_model.", "model.").replace("model.visual.", "visual.")


def test_a_short_hf_checkpoint_is_refused(tmp_path):
    hf = _hf_model()
    flat = {_legacy(k): v for k, v in hf.state_dict().items()
            if "blocks.1.attn.qkv.bias" not in k}
    hf.config.save_pretrained(str(tmp_path))
    save_state_dict(flat, str(tmp_path))
    with pytest.raises(KeyError, match="blocks_1.qkv.bias"):
        Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path), device="cpu")


def test_fault22_published_config_layout(tmp_path):
    """ROADMAP C.22: the published config.json (transformers 4.41) keeps the
    language model's fields at the top level, with no `text_config`, the
    M-RoPE sections in `rope_scaling` and the tower's channels as `in_chans`.
    JAX's Qwen2VLConfig reads `text_config` alone and so still takes the
    Llama defaults (vocab 32,000, 4,096 wide). The port departs from JAX
    here, by name: it reads the top-level fields, `mrope_section` from
    `rope_scaling` and `in_chans`, so it reads the checkpoint, and its
    logits equal transformers' (atol 1e-4, rtol 1e-4). `save_published`
    writes the same layout, and the port reads it back to an equal config
    and bit-equal tensors."""
    import json

    from paddlemix_tpu_torch.models.qwen2_vl import published_config_dict, save_published

    hf = _hf_model()
    text = {k: v for k, v in hf.config.text_config.to_dict().items()
            if k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                     "num_attention_heads", "num_key_value_heads", "rms_norm_eps",
                     "max_position_embeddings", "tie_word_embeddings")}
    published = dict(text, model_type="qwen2_vl", rope_theta=1e6, image_token_id=150,
                     video_token_id=151, vision_start_token_id=149, vision_end_token_id=148,
                     rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
                     vision_config=dict(depth=2, embed_dim=32, num_heads=2, in_chans=3,
                                        patch_size=4, spatial_merge_size=2,
                                        temporal_patch_size=2, hidden_size=256, mlp_ratio=2.0))
    assert "text_config" not in published
    (tmp_path / "config.json").write_text(json.dumps(published))
    save_state_dict({_legacy(k): v for k, v in hf.state_dict().items()}, str(tmp_path))
    jcfg, tcfg = JConfig.from_dict(published), Qwen2VLConfig.from_dict(published)
    assert (jcfg.text.vocab_size, jcfg.text.hidden_size) == (32000, 4096)  # JAX: C.22
    assert (tcfg.text.vocab_size, tcfg.text.hidden_size, tcfg.text.kv_heads) == (160, 256, 1)
    assert tcfg.mrope_section == (16, 24, 24) and tcfg.vision.in_channels == 3
    model = Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path), device="cpu")
    enc = tproc.Qwen2VLImageProcessor(**dict(PROC, pad_to_multiple=4))([_image(16, 24, 1)])
    n = int(np.prod(enc["image_grid_thw"][0])) // 4
    ids = np.asarray([[5, 149] + [150] * n + [148, 9, 11]])
    pos = get_rope_index(ids, enc["image_grid_thw"], 150, 151, 2)
    with torch.inference_mode():
        hf_logits = hf(input_ids=torch.from_numpy(ids),
                       pixel_values=torch.from_numpy(enc["pixel_patches"][0]),
                       image_grid_thw=torch.from_numpy(enc["image_grid_thw"])).logits
        out, _ = model(ids, pos, *_vision_args(enc))
    _close(hf_logits, out, 1e-4, 1e-4)
    save_published(model, str(tmp_path / "again"), max_shard_bytes=100_000)
    written = json.loads((tmp_path / "again" / "config.json").read_text())
    assert "text_config" not in written and written == published_config_dict(model.config)
    back = Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path / "again"), device="cpu")
    assert back.config.text == model.config.text and back.config.vision == model.config.vision
    mine = model.state_dict()
    assert all(torch.equal(v, mine[k]) for k, v in back.state_dict().items())


def test_save_pretrained_and_hf_layout_round_trips(pair, tmp_path):
    """`save_pretrained` (flax keys) read back by the port and by JAX, bit
    for bit; `hf_state_dict` written in shards (the published layout: 5-D
    patch embedding, transformers' names) read back by the port, bit for
    bit, its names and shapes transformers' own."""
    jmodel, model = pair
    model.save_pretrained(str(tmp_path / "flax"), max_shard_bytes=100_000)
    back = Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path / "flax"), device="cpu")
    jback = JQwen2VL.from_pretrained(str(tmp_path / "flax"))
    jref = flax_to_torch_state_dict(flatten_params(jback.params), model, QWEN2_VL_KEY_MAP)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v) and torch.equal(jref[k], v), k
    hf_flat = hf_state_dict(model)
    assert hf_flat["visual.patch_embed.proj.weight"].shape == (32, 3, 2, 4, 4)
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Qwen2VLConfig(
        vision_config=dict(TINY["vision_config"], in_channels=3), **TINY["text_config"],
        rope_scaling={"type": "mrope", "mrope_section": [4, 4, 4]}, tie_word_embeddings=False)
    hf_keys = {k: tuple(v.shape) for k, v in
               transformers.Qwen2VLForConditionalGeneration(hf_cfg).state_dict().items()}
    hf_keys = {_legacy(k): v for k, v in hf_keys.items()}
    assert {k: tuple(v.shape) for k, v in hf_flat.items()} == hf_keys
    model.config.save_pretrained(str(tmp_path / "hf"))
    save_state_dict(hf_flat, str(tmp_path / "hf"), max_shard_bytes=100_000)
    back = Qwen2VLForConditionalGeneration.from_pretrained(str(tmp_path / "hf"), device="cpu",
                                                           dtype=torch.bfloat16)
    for k, v in model.state_dict().items():
        got = back.state_dict()[k]
        assert got.dtype == (torch.float32 if "norm" in k or "merger_ln" in k
                             else torch.bfloat16), k
        assert torch.equal(got, v.to(got.dtype)), k
    # convert_hf_state_dict makes views: nothing is copied
    flax = convert_hf_state_dict(dict(hf_flat))
    assert flax["visual.patch_embed.kernel"].data_ptr() == \
        model.visual.patch_embed.weight.data_ptr()


# ------------------------------------------------- faults of the reference
def _hf_tower(hidden_act, scale):
    """transformers' Qwen2-VL vision tower (TINY's widths, output 48) with
    weights moved by seeded noise x `scale`, and the port's tower on the same
    weights through `convert_hf_state_dict`."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.qwen2_vl.modeling_qwen2_vl import (
        Qwen2VisionTransformerPretrainedModel,
    )

    vcfg = transformers.Qwen2VLConfig(vision_config=dict(
        TINY["vision_config"], in_channels=3, hidden_act=hidden_act)).vision_config
    torch.manual_seed(0)
    hf = Qwen2VisionTransformerPretrainedModel(vcfg).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(scale * torch.randn_like(p))
    flax = convert_hf_state_dict({f"visual.{k}": v for k, v in hf.state_dict().items()})
    tower = Qwen2VisionTransformer(Qwen2VLConfig.from_dict(TINY).vision).eval()
    tower.load_state_dict(flax_to_torch_state_dict(
        flax, tower, lambda k: QWEN2_VL_KEY_MAP(f"visual.{k}")))
    return hf, tower


def _tower_gap(hf, tower, patches, grid, segments):
    with torch.inference_mode():
        ref = hf(torch.from_numpy(patches), grid_thw=torch.from_numpy(np.asarray(grid)))
        pos = tproc.vision_patch_positions([tuple(g) for g in grid], 2)
        out = tower(torch.from_numpy(patches)[None], torch.from_numpy(pos)[None],
                    torch.from_numpy(segments)[None])[0]
    return ((out - ref).norm() / ref.norm()).item()


def test_fault16_vision_mlp_gelu_against_hf():
    """ROADMAP C.16: the JAX block (and the port) runs exact GELU where the
    published tower runs quick_gelu. At weights large enough for the two to
    part, the port's tower is far from transformers' quick_gelu tower and
    agrees with its gelu one (more than 1,000 times closer)."""
    enc = tproc.Qwen2VLImageProcessor(**dict(PROC, pad_to_multiple=4))([_image(16, 24, 0)])
    patches, grid = enc["pixel_patches"][0], enc["image_grid_thw"]
    segments = enc["patch_segments"][0]
    gaps = {act: _tower_gap(*_hf_tower(act, 0.5), patches, grid, segments)
            for act in ("quick_gelu", "gelu")}
    assert gaps["gelu"] < 1e-5 and gaps["quick_gelu"] > 1e-3, gaps


def test_fault18_one_segment_per_video_against_hf():
    """ROADMAP C.18: JAX gives a whole video one attention segment; the
    upstream tower splits it by temporal group. Over a 2-group video the
    port (JAX's rule) differs from transformers' tower, and equals it when
    given a segment per group."""
    hf, tower = _hf_tower("gelu", 0.1)
    video = np.random.RandomState(0).rand(4, 16, 24, 3).astype(np.float32)
    patches, grid = tproc.extract_patches(video, 4, 2, 2)
    assert grid == (2, 4, 6)
    one = np.ones(len(patches), np.int32)
    per_group = np.repeat(np.arange(1, 3, dtype=np.int32), 24)
    assert _tower_gap(hf, tower, patches, [grid], one) > 1e-3
    assert _tower_gap(hf, tower, patches, [grid], per_group) < 1e-5


def test_fault21_patch_channel_order_against_hf():
    """ROADMAP C.21: JAX's `extract_patches` lays a patch out (t, c, i, j);
    the published conv3d weight (1280, 3, 2, 14, 14), flattened as JAX
    flattens it, and transformers' processor read (c, t, i, j). The port
    keeps JAX's order: its patches equal transformers' only after the swap."""
    transformers = pytest.importorskip("transformers")
    img = _image(56, 84, 0).astype(np.float32)
    hf = transformers.Qwen2VLImageProcessor(do_resize=False, do_rescale=False,
                                            do_normalize=False)
    ref = hf(images=img, return_tensors="np")["pixel_values"]
    p, _ = tproc.extract_patches(img)
    assert not np.array_equal(p, ref)
    swapped = p.reshape(-1, 2, 3, 14, 14).transpose(0, 2, 1, 3, 4).reshape(p.shape)
    assert np.array_equal(swapped, ref)


# ------------------------------------------------------------ full width
def test_launch_walk_and_size_at_full_width_on_meta():
    """Qwen2-VL-7B: 8.29 B parameters; a 128-token image request with the
    smoke's 4,864 patch rows launches B11 57 x 128, B7 28 x 127, B10 65 and
    B1 32 times; a text-only one-token prompt launches B7 in its prefill."""
    with torch.device("meta"):
        model = Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_dict(QWEN2_VL_7B))
    assert sum(p.numel() for p in model.parameters()) == 8_291_375_616
    text = model.config.text
    assert (text.num_attention_heads // text.kv_heads, text.head_dim_) == (7, 128)
    assert expected_launches_qwen2_vl(model, 1230, 128, 4864) == dict(
        rms_norm=57 * 128, decode_attention=28 * 127, layer_norm=65, flash_attention=32)
    assert expected_launches_qwen2_vl(model, 1, 4) == dict(
        rms_norm=57 * 4, decode_attention=28 * 4, layer_norm=0, flash_attention=0)
    ids = prompt_ids(model.config, [("image", 1196)], seed=0)
    assert ids.shape == (1, 1230) and int(ids[0, 0]) == 151652 and int(ids[0, 1197]) == 151653
    assert int((ids == 151655).sum()) == 1196 and int(ids[0, 1198:].max()) < 151643
    two = prompt_ids(model.config, [("image", 391), ("image", 391)])
    video = prompt_ids(model.config, [("video", 2392)])
    assert two.shape == (1, 818) and video.shape == (1, 2426)


def test_auto_classes_know_qwen2(tmp_path):
    """A Qwen2 language model's directory (model_type "qwen2") is the port's
    Llama with biases, as in the JAX registry."""
    cfg = LlamaConfig.from_dict(dict(TINY["text_config"], attention_bias=True))
    model = LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(tmp_path))
    import json

    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), model_type="qwen2")))
    assert isinstance(AutoConfig.from_pretrained(str(tmp_path)), LlamaConfig)
    back = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(back, LlamaForCausalLM) and back.config.attention_bias
    assert torch.equal(back.model.layers[0].self_attn.q_proj.bias,
                       model.model.layers[0].self_attn.q_proj.bias)
