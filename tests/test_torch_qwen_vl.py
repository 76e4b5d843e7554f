"""The port's Qwen-VL (paddlemix_tpu_torch.models.qwen_vl and
processors.qwen_vl_processing) against the JAX package on shared inputs and
weights, on the CPU: the image processor bit for bit, `from_list_format`,
the query call and ChatML masking over one tokenizer; the sincos table and
the bicubic resize; the ViT-bigG trunk, the Resampler and the whole tower at
grids other than the tables' (the position table's 16 and the Resampler's);
the per-head qkv views' strides; the splice; the logits without and over the
cache and greedy tokens, with NTK alpha 3 and a logn length the decode steps
cross; the published checkpoint's keys (ROADMAP C.41); the directories both
ways; and the launch walk of Qwen-VL-Chat on the meta device.

The tiny model is tests/test_internvl_eva.py's Qwen-VL (its CLIP-style vision
names taken as JAX takes them), with 4 queries. The JAX package initialises
it, every leaf is then moved by seeded noise, and `core.convert.QWEN_VL_KEY_MAP`
carries it over, every key consumed. fp32 throughout: the sides differ by
summation order (flax's LayerNorm E[x^2] - E[x]^2, the port's plain B10
two-pass; XLA's dots; XLA's and torch's log), inside atol 2e-5, rtol 1e-4.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama.modeling import KVCache as JKVCache
from paddlemix_tpu.models.qwen_vl import QwenVLConfig as JConfig
from paddlemix_tpu.models.qwen_vl import QwenVLForConditionalGeneration as JQwenVL
from paddlemix_tpu.models.qwen_vl import visual as jvisual
from paddlemix_tpu.processors import qwen_vl_processing as jproc
from paddlemix_tpu_torch.auto import AutoModel
from paddlemix_tpu_torch.core import QWEN_VL_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.core.modeling import save_state_dict
from paddlemix_tpu_torch.models.llama import LlamaConfig
from paddlemix_tpu_torch.models.qwen_vl import (
    QWEN_VL_CHAT,
    QwenVLConfig,
    QwenVLForConditionalGeneration,
    convert_hf_state_dict,
    expected_launches_qwen_vl,
    get_2d_sincos_pos_embed,
    get_abs_pos,
)
from paddlemix_tpu_torch.models.qwen_vl import visual as tvisual
from paddlemix_tpu_torch.processors import qwen_vl_processing as tproc

pytestmark = pytest.mark.torch_port

TINY = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, image_size=32, patch_size=8),
    text_config=dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
                     eos_token_id=2, use_logn_attn=True, logn_seq_length=14,
                     rope_ntk_alpha=3.0),
    num_queries=4, image_token_id=120)
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
    jmodel = JQwenVL.from_config(JConfig.from_dict(TINY), seed=0)
    jmodel = JQwenVL(jmodel.config, params=_noisy(jmodel.params, 1))
    model = QwenVLForConditionalGeneration(QwenVLConfig.from_dict(TINY)).eval()
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   QWEN_VL_KEY_MAP))
    return jmodel, model


def _close(ref, out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _images(n, size=32, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _prompt(images, text_len=4, seed=0):
    """Each image's 4 placeholders after a label id, then text."""
    rs = np.random.RandomState(seed)
    ids = []
    for _ in range(images):
        ids += [int(rs.randint(7, 110))] + [120] * 4 + [121]
    return np.asarray([ids + list(rs.randint(7, 110, text_len))], np.int64)


class FakeTokenizer:
    """Words to ids by crc32, ChatML's specials and "\\n" their own."""

    im_start_id, im_end_id = 90, 91
    _specials = {"<|im_start|>": 90, "<|im_end|>": 91}

    def __call__(self, text, **kw):
        import re

        ids = []
        for p in re.split(r"(<\|im_start\|>|<\|im_end\|>|\n)", text):
            if p == "\n":
                ids.append(9)
            elif p in self._specials:
                ids.append(self._specials[p])
            elif p:
                ids.extend(100 + zlib.crc32(w.encode()) % 1000 for w in p.split())
        return {"input_ids": ids}


# ------------------------------------------------------------- processor
def test_image_processor_and_query_equal_jax():
    """448 bicubic + CLIP normalize bit for bit (an array, a PIL image and a
    jpeg path); `from_list_format`; the query's ids and images."""
    from PIL import Image

    images = [(np.random.RandomState(i).rand(60 + 40 * i, 90, 3) * 255).astype(np.uint8)
              for i in range(2)]
    images.append(Image.fromarray(images[0]))
    out = tproc.QwenVLImageProcessor()(images)
    ref = jproc.QwenVLImageProcessor()(images)
    assert out.shape == (3, 448, 448, 3) and out.dtype == ref.dtype == np.float32
    assert np.array_equal(out, ref)
    q = [{"image": images[0]}, {"text": "describe"}, {"image": images[1]}, {"text": "and"}]
    assert tproc.QwenVLProcessor.from_list_format(q) == jproc.QwenVLProcessor.from_list_format(q)
    assert tproc.QwenVLProcessor.from_list_format([{"image": "a.jpg"}]) == \
        "Picture 1: <img>a.jpg</img>\n"
    tok = FakeTokenizer()
    got = tproc.QwenVLProcessor(tokenizer=tok)(query=q)
    want = jproc.QwenVLProcessor(tokenizer=tok)(query=q)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    with pytest.raises(ValueError):
        tproc.QwenVLProcessor(tokenizer=tok)()


def test_train_preprocess_equals_jax():
    """ChatML assembly and -100 masking of two turns and an image tag, bit for
    bit; the assistant replies kept, the user's words masked."""
    tok = FakeTokenizer()
    conv = ("<|im_start|>user\nPicture 1: <img>a.jpg</img>\nwhat color<|im_end|>\n"
            "<|im_start|>assistant\nblue sky<|im_end|>\n"
            "<|im_start|>user\nand now<|im_end|>\n<|im_start|>assistant\ngreen<|im_end|>\n")
    got = tproc.QwenVLProcessor(tokenizer=tok, max_len=64)(record={"conversations": conv},
                                                          mode="train")
    want = jproc.QwenVLProcessor(tokenizer=tok, max_len=64)(record={"conversations": conv},
                                                           mode="train")
    assert set(got) == set(want) == {"input_ids", "labels", "images"}
    for key in ("input_ids", "labels"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["images"] == want["images"] == ["a.jpg"]
    kept = set(got["labels"][got["labels"] != tproc.IGNORE_TOKEN_ID].tolist())
    assert tok("blue sky green")["input_ids"][0] in kept
    assert tok("what")["input_ids"][0] not in kept


# ---------------------------------------------------------------- tower
@pytest.mark.parametrize("src,dst", [(16, 4), (16, 32), (2, 4), (16, 16)])
def test_bicubic_resize_and_sincos_equal_jax(src, dst):
    table = np.random.RandomState(src + dst).randn(src * src, 24).astype(np.float32)
    assert np.array_equal(tvisual._bicubic_matrix(src, dst), jvisual._bicubic_matrix(src, dst))
    out = get_abs_pos(torch.from_numpy(table), dst * dst)
    _close(jvisual.get_abs_pos(jnp.asarray(table), dst * dst), out, 1e-6, 1e-6)
    assert np.array_equal(get_2d_sincos_pos_embed(24, dst),
                          jvisual.get_2d_sincos_pos_embed(24, dst))


def test_qkv_views_are_per_head_and_read_in_place(pair):
    """ViT-bigG's split is per head, (..., heads, 3 hd) -> q | k | v: q, k and
    v are views at a stride of 3 hd a head (not InternViT's global thirds)."""
    _, model = pair
    block = model.visual.resblocks[0]
    q, k, v = block.split_qkv(torch.randn(2, 16, 32))
    assert q.shape == (2, 16, 2, 16)
    assert q.stride() == k.stride() == v.stride() == (16 * 96, 96, 48, 1)
    assert k.data_ptr() - q.data_ptr() == 16 * 4 and v.data_ptr() - k.data_ptr() == 16 * 4


@pytest.mark.parametrize("size", [32, 48], ids=["grid4", "grid6"])
def test_tower_and_resampler_match_jax(pair, size):
    """The trunk (its 16 x 16 table resized to 4 x 4 or 6 x 6), the Resampler
    (its 2 x 2 sincos keys resized to the grid) and the whole tower."""
    jmodel, model = pair
    x = _images(2, size, seed=size)
    params = {"params": jmodel.params}
    ref = jmodel.module.apply(params, jnp.asarray(x), method=lambda m, p: m.encode_images(p))
    with torch.inference_mode():
        out = model.encode_images(x)
    assert out.shape == (2, 4, 32)
    _close(ref, out)
    feats = np.random.RandomState(5).randn(2, (size // 8) ** 2, 32).astype(np.float32)
    pool = jvisual.Resampler(num_queries=4, out_dim=32, num_heads=1)
    pref = pool.apply({"params": jmodel.params["visual"]["attn_pool"]}, jnp.asarray(feats))
    with torch.inference_mode():
        pout = model.visual.attn_pool(torch.from_numpy(feats))
    _close(pref, pout)


# ---------------------------------------------------------------- model
def test_splice_matches_jax(pair):
    jmodel, model = pair
    ids = np.asarray([[5, 120, 120, 7, 120, 9], [120, 1, 2, 120, 4, 5]])
    feats = np.random.RandomState(3).randn(1, 4, 32).astype(np.float32)
    ref = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(ids), jnp.asarray(feats),
                              method=lambda m, i, f: m.splice(i, f))
    with torch.inference_mode():
        out = model.splice(torch.from_numpy(ids), torch.from_numpy(feats))
    _close(ref, out, 0, 0)


def test_forward_logits_match_jax_without_and_over_the_cache(pair):
    """Two images, NTK alpha 3 and logn past position 14: the cache-free
    forward, the prefill over the cache, then decode steps whose positions
    cross the logn length (scale above 1)."""
    jmodel, model = pair
    x, ids = _images(2), _prompt(2, text_len=4)
    s = ids.shape[1]
    assert s == 16 > model.config.text.logn_seq_length
    params = {"params": jmodel.params}
    jids = jnp.asarray(ids.astype(np.int32))
    ref, _ = jmodel.module.apply(params, jids, jnp.asarray(x))
    with torch.inference_mode():
        out, _ = model(ids, x)
    _close(ref, out)
    jcache = JKVCache.create(jmodel.config.text, 1, s + 3, jnp.float32)
    ref, jcache = jmodel.module.apply(params, jids, jnp.asarray(x), cache=jcache)
    cache = model.init_cache(1, s + 3)
    with torch.inference_mode():
        out, cache = model(ids, x, cache=cache)
    _close(ref, out)
    for tok in (7, 8):
        ref, jcache = jmodel.module.apply(params, jnp.asarray([[tok]]), None,
                                          jcache.lengths[:, None], cache=jcache)
        with torch.inference_mode():
            out, cache = model(torch.tensor([[tok]]), None, cache.lengths[:, None], cache=cache)
        _close(ref, out)


def test_ntk_and_logn_are_what_jax_takes(pair):
    """rope_base = theta alpha^(hd / (hd - 2)); the logn scale 1 up to the
    logn length and log(i) / log(n) past it; `ntk_alpha_for` as JAX's; the
    options no longer refused by the Llama config."""
    from paddlemix_tpu.models.llama.configuration import LlamaConfig as JLlamaConfig
    from paddlemix_tpu_torch.models.llama.modeling import logn_scale

    _, model = pair
    t = model.config.text
    assert t.rope_base == pytest.approx(10000.0 * 3.0 ** (16 / 14), rel=1e-12)
    scale = logn_scale(torch.arange(20)[None], 14)[0, :, 0, 0]
    assert torch.equal(scale[:14], torch.ones(14))
    assert scale[14].item() == pytest.approx(np.log(15) / np.log(14), rel=1e-6)
    j = JLlamaConfig(logn_seq_length=2048)
    for ctx in (100, 2048, 2049, 4096, 5000, 20000):
        assert LlamaConfig(logn_seq_length=2048).ntk_alpha_for(ctx) == j.ntk_alpha_for(ctx)
    assert LlamaConfig.from_dict(dict(use_logn_attn=True, rope_ntk_alpha=2.0)).use_logn_attn


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


def test_greedy_tokens_equal_a_jax_greedy_loop(pair):
    """One image, a 10-token prompt, 10 new tokens: positions 10-19 cross the
    logn length 14."""
    jmodel, model = pair
    x, ids = _images(1, seed=2), _prompt(1, text_len=4, seed=2)
    n = 10
    out = model.generate(ids, x, max_new_tokens=n, eos_token_id=-1)
    assert out.shape == (1, n) and out.dtype == torch.int32
    assert out[0].tolist() == _jax_greedy(jmodel, ids, x, n)


# ------------------------------------------------------------ checkpoints
def _hf_flat(model):
    """The tiny model's weights under the published Qwen-VL names: the
    tower under `transformer.visual` (resblocks under `transformer.`, attn /
    mlp submodules, the Resampler's packed nn.MultiheadAttention in_proj),
    the language model as QWen's (`wte`, `h.N.{ln_1, attn.c_attn, attn.c_proj,
    ln_2, mlp.w1, mlp.w2, mlp.c_proj}`, `ln_f`, `lm_head`)."""
    sd = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            k = "transformer." + k
            k = k.replace(".resblocks.", ".transformer.resblocks.")
            for a, b in (("in_proj", "attn.in_proj"), ("out_proj", "attn.out_proj"),
                         ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
                if ".resblocks." in k:
                    k = k.replace(f".{a}.", f".{b}.")
            if ".attn_pool.out_proj." in k:
                k = k.replace(".attn_pool.out_proj.", ".attn_pool.attn.out_proj.")
            if ".attn_pool.q_proj." in k or ".attn_pool.k_proj." in k or \
                    ".attn_pool.v_proj." in k:
                continue
        else:
            k = k.replace("language_model.model.embed_tokens.weight", "transformer.wte.weight")
            k = k.replace("language_model.model.norm.weight", "transformer.ln_f.weight")
            k = k.replace("language_model.lm_head.", "lm_head.")
            k = k.replace("language_model.model.layers.", "transformer.h.")
            for a, b in ((".input_layernorm.", ".ln_1."), (".post_attention_layernorm.", ".ln_2."),
                         (".self_attn.o_proj.", ".attn.c_proj."), (".mlp.up_proj.", ".mlp.w1."),
                         (".mlp.gate_proj.", ".mlp.w2."), (".mlp.down_proj.", ".mlp.c_proj.")):
                k = k.replace(a, b)
            if ".self_attn." in k:
                continue
        out[k] = v
    for kind in ("weight", "bias"):
        out[f"transformer.visual.attn_pool.attn.in_proj_{kind}"] = torch.cat(
            [sd[f"visual.attn_pool.{n}_proj.{kind}"] for n in "qkv"])
        for i in range(model.config.text.num_hidden_layers):
            out[f"transformer.h.{i}.attn.c_attn.{kind}"] = torch.cat(
                [sd[f"language_model.model.layers.{i}.self_attn.{n}_proj.{kind}"] for n in "qkv"])
    return out


def test_fault41_published_keys_read_in_full(pair, tmp_path):
    """ROADMAP C.41: JAX's `_QWEN_VL_KEY_MAP` leaves four kinds of the
    language model's weights under keys its model has no parameter for (the
    embedding as `embed_tokens.kernel`, the fused `c_attn` as
    `self_attn.qkv_proj`, which only `fused_qkv` builds, the MLP's output
    `mlp.c_proj` as `layers_N.c_proj`, the final norm as `norm.kernel`), so
    its non-strict read keeps them random. The port's `convert_hf_state_dict`
    splits c_attn into q / k / v and reads every weight, bit for bit, and
    agrees with JAX's on every key JAX's model takes."""
    jmodel, model = pair
    flat = _hf_flat(model)
    ref = JQwenVL.convert_foreign_state_dict({k: v.numpy() for k, v in flat.items()}, None)
    params = set(flatten_params(jmodel.params))
    unread = {k for k in ref if k not in params}
    assert {k.split(".", 2)[-1] if "layers_" in k else k for k in unread} == {
        "language_model.embed_tokens.kernel", "self_attn.qkv_proj.kernel",
        "self_attn.qkv_proj.bias", "c_proj.kernel", "language_model.norm.kernel"}
    out = convert_hf_state_dict(flat)
    assert set(out) == params
    for k in set(ref) & set(out):
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k
    back = flax_to_torch_state_dict(out, model, QWEN_VL_KEY_MAP)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    # a directory of the published keys: the port reads the embedding, JAX
    # keeps its own init there
    model.config.save_pretrained(str(tmp_path))
    save_state_dict(flat, str(tmp_path))
    read = QwenVLForConditionalGeneration.from_pretrained(str(tmp_path), device="cpu")
    assert torch.equal(read.language_model.model.embed_tokens.weight,
                       model.language_model.model.embed_tokens.weight)
    jread = JQwenVL.from_pretrained(str(tmp_path))
    jemb = np.asarray(flatten_params(jread.params)["language_model.embed_tokens.embedding"])
    assert not np.array_equal(jemb, flat["transformer.wte.weight"].numpy())


def test_directories_both_ways(pair, tmp_path):
    """The port's save_pretrained read back by the port, by AutoModel and by
    JAX; JAX's save_pretrained read by the port: 0 tensors differing; the
    config round-trips its NTK and logn fields."""
    jmodel, model = pair
    model.save_pretrained(str(tmp_path / "port"), max_shard_bytes=100_000)
    back = QwenVLForConditionalGeneration.from_pretrained(str(tmp_path / "port"), device="cpu")
    auto = AutoModel.from_pretrained(str(tmp_path / "port"), device="cpu")
    jback = JQwenVL.from_pretrained(str(tmp_path / "port"))
    jref = flax_to_torch_state_dict(flatten_params(jback.params), model, QWEN_VL_KEY_MAP)
    jmodel.save_pretrained(str(tmp_path / "jax"))
    from_jax = QwenVLForConditionalGeneration.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for k, v in model.state_dict().items():
        for other in (back, auto, from_jax):
            assert torch.equal(other.state_dict()[k], v), k
        assert torch.equal(jref[k], v), k
    assert back.config.text == model.config.text and from_jax.config.text.rope_ntk_alpha == 3.0
    assert jback.config.text.use_logn_attn and jback.config.text.logn_seq_length == 14


# ------------------------------------------------------------ full width
def test_full_width_config_and_launch_walk():
    """Qwen-VL-Chat at its published widths on the meta device: 9.66 B
    parameters (the tower 1.94 B), MLP 8,192 (int(1664 x 4.9231)); the walk
    of a one-image request (1 + 48 x 2 + 3 B10, 48 + 1 B1, 65 B11 and 32 B7 a
    token)."""
    cfg = QwenVLConfig.from_dict(QWEN_VL_CHAT)
    with torch.device("meta"):
        model = QwenVLForConditionalGeneration(cfg)
    assert 9.6e9 < sum(p.numel() for p in model.parameters()) < 9.7e9
    assert model.visual.resblocks[0].c_fc.out_features == 8192
    assert model.visual.attn_pool.num_heads == 32 and cfg.text.use_logn_attn
    walk = expected_launches_qwen_vl(model, 300, 128, images=1)
    assert walk == {"rms_norm": 65 * 128, "decode_attention": 32 * 127, "layer_norm": 100,
                    "flash_attention": 49}
    assert cfg.text.ntk_alpha_for(2200) == 3.0 and cfg.text.ntk_alpha_for(2048) == 1.0
