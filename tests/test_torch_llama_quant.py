"""Llama's dynamic a8w8 and a8w4 in the port (paddlemix_tpu_torch.ops.quant
N1 `a8w8_matmul`, N2 `a8w4_matmul`, `models.llama` quant modes) against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Held:
the int8 and int4 weight quantizers and the int4 unpack bit for bit; the
per-row activation quantizer and both plain products bit for bit against
JAX's `MXUDense` apply on the same kernel_q / scale, in fp32 and bf16, at
widths whose x / sx land on .5 ties and with zero rows; wint4 equal to a8w4;
a tiny Llama quantized by the JAX package and carried across by
`flax_to_torch_state_dict`, and the same bf16 weights quantized by the port's
own `quantize_`, against the JAX model (logits and greedy tokens); the
config's quant field; in-place quantization; the tile plans' walks and their
layout against what the library answered on an H100; the launch walk on the
meta device. The kernels themselves are held against these plain versions
on the card (tests/test_torch_quant_kernels.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chip_smoke import A8W_RAGGED, A8W_SHAPES
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.models.llama import greedy_generate as jgreedy_generate
from paddlemix_tpu.models.llama.modeling import MXUDense as JMXUDense
from paddlemix_tpu.ops import quant as jquant
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, MXUDense
from paddlemix_tpu_torch.models.llama import greedy_generate
from paddlemix_tpu_torch.models.llama.configuration import QUANT_MODES
from paddlemix_tpu_torch.models.llava import (
    LlavaForConditionalGeneration,
    expected_launches_llava,
    llava7b_config,
    random_llava,
)
from paddlemix_tpu_torch.models.llava.modeling import LlavaConfig
from paddlemix_tpu_torch.ops import gemm_tiles as gt
from paddlemix_tpu_torch.ops import quant as tquant

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
NEW_TOKENS = 6
# Each quantized op is bit-exact with JAX's on the same input (the tests
# below), but the models' fp32 sums upstream (attention, norms) differ in
# their last bits, which moves an x / sx lying that close to a .5 tie by one
# int8 step of |x|max / 127; a wrong nibble order or scale moves the logits by
# O(1). Measured at these weights: at most 2.5e-7 of |logits|max 3.8 (no
# step moved here; in test_torch_llava.py's tiny LLaVA one did, 1.1e-2).
LOGIT_TOL = 2e-2


def _int4(w):
    return jquant.quantize_weights_int4(jnp.asarray(w))


def _int8(w):
    return jquant.quantize_weights_int8(jnp.asarray(w))


# --------------------------------------------------------- the quantizers
@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quantizers_match_jax(bits):
    rs = np.random.RandomState(0)
    w = (rs.randn(256, 384) * 0.05).astype(np.float32)  # flax (K, N)
    w[:, 7] = 0.0  # an all-zero output column takes scale 1.0
    w[3, 9] = 2.5 * np.abs(w[:, 9]).max()  # a column whose absmax is one outlier
    jq, js = (_int4 if bits == 4 else _int8)(w)
    port = tquant.quantize_weights_int4 if bits == 4 else tquant.quantize_weights_int8
    wq, scale = port(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    assert wq.shape == ((384, 128) if bits == 4 else (384, 256))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert scale[7].item() == 1.0 and (wq[7] == 0).all()


def test_int4_pack_splits_the_halves_and_unpacks_as_jax():
    rs = np.random.RandomState(1)
    w = (rs.randn(64, 24) * 0.1).astype(np.float32)
    jq, js = _int4(w)
    wq, _ = tquant.quantize_weights_int4(torch.from_numpy(np.ascontiguousarray(w.T)))
    un = tquant.unpack_int4(wq)
    np.testing.assert_array_equal(un.numpy(), np.asarray(jquant.unpack_int4(jq), np.int8).T)
    # row k of w in the low nibble of byte k, row k + K / 2 in its high nibble
    q = np.clip(np.round(w / np.asarray(js)), -7, 7).astype(np.int8).T
    np.testing.assert_array_equal(un.numpy(), q)
    b = wq.numpy().astype(np.int32)
    np.testing.assert_array_equal(((b << 28) >> 28), q[:, :32])
    np.testing.assert_array_equal(((b << 24) >> 28), q[:, 32:])
    # every nibble value, -8 included, sign-extends
    every = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[None]
    lo, hi = tquant.unpack_int4(every).reshape(2, 256)
    assert lo.tolist() == [((v & 15) ^ 8) - 8 for v in range(-128, 128)]
    assert hi.tolist() == [v >> 4 for v in range(-128, 128)]


def test_int4_quantizer_refuses_an_odd_width():
    with pytest.raises(ValueError):
        tquant.quantize_weights_int4(torch.ones(4, 7))


def _tie_rows(rs, rows, k):
    """x whose row r has |x|max 127 (sx = 1.0 exactly), most values on .5
    ties, one zero row, one row of tiny values below the 1e-6 floor and
    random rows."""
    x = rs.randn(rows, k).astype(np.float32) * 3
    x[0] = rs.randint(-254, 255, size=k) / 2.0
    x[0, 0] = 127.0
    if rows > 1:
        x[1] = 0.0
    if rows > 2:
        x[2] = rs.randn(k) * 1e-8
    return x


def _jax_dense(mode, kq, scale, x, dtype):
    mod = JMXUDense(scale.shape[0], use_bias=False, dtype=dtype, quant=mode)
    return np.asarray(mod.apply({"params": {"kernel_q": kq, "scale": scale}}, x).astype(
        jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows, k, n", [(1, 128, 64), (8, 256, 96), (68, 128, 256),
                                         (3, 4096, 32)])
def test_rows_quantizer_and_products_match_jax_mxudense(rows, k, n, dtype):
    rs = np.random.RandomState(rows + k)
    x = _tie_rows(rs, rows, k)
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdtype)
    xj = jnp.asarray(x).astype(jdtype)
    # the activation quantizer, as the JAX branch writes it
    x2 = xj.astype(jdtype)
    amax = jnp.max(jnp.abs(x2), axis=-1, keepdims=True)
    jsx = jnp.maximum(amax.astype(jnp.float32), 1e-6) / 127.0
    jxq = jnp.clip(jnp.round(x2.astype(jnp.float32) / jsx), -127, 127).astype(jnp.int8)
    xq, sx = tquant.quantize_rows_int8(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    if dtype == "float32":  # row 0 lands on .5 ties, which round to even
        ties = torch.from_numpy(x[0] * 2 % 2 == 1)
        assert sx[0].item() == 1.0 and ties.sum() > k // 4 and (xq[0][ties] % 2 == 0).all()
    if rows > 1:  # a zero row: sx at the 1e-6 floor, every value 0
        assert (xq[1] == 0).all() and sx[1].item() == np.float32(1e-6) / np.float32(127)
    for mode in ("a8w8", "a8w4"):
        kq, sc = (_int4 if mode == "a8w4" else _int8)(w)
        ref = _jax_dense(mode, kq, sc, xj, jdtype)
        port = tquant.a8w4_matmul_ref if mode == "a8w4" else tquant.a8w8_matmul_ref
        out = port(xt, torch.from_numpy(np.asarray(kq).T.copy()), torch.from_numpy(np.asarray(sc)))
        assert out.dtype == tdtype and out.shape == (rows, n)
        np.testing.assert_array_equal(out.float().numpy(), ref)


def test_wint4_is_a8w4():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(5, 3, 64).astype(np.float32))
    w = torch.from_numpy(rs.randn(48, 64).astype(np.float32))
    outs = {}
    for mode in ("a8w4", "wint4"):
        dense = MXUDense(64, 48, bias=True)
        dense.weight.data.copy_(w)
        dense.bias.data.fill_(0.25)
        assert dense.quantize_(mode) == 48 * 64 * 4 - 48 * 32 - 48 * 4
        assert dense.quant == mode and dense.kernel_q.shape == (48, 32)
        with torch.no_grad():
            outs[mode] = dense(x)
    assert outs["a8w4"].shape == (5, 3, 48)
    assert torch.equal(outs["a8w4"], outs["wint4"])
    # and the JAX package's two modes agree on the same weights
    kq, sc = _int4(w.numpy().T)
    xj = jnp.asarray(x.numpy().reshape(15, 64))
    np.testing.assert_array_equal(_jax_dense("a8w4", kq, sc, xj, jnp.float32),
                                  _jax_dense("wint4", kq, sc, xj, jnp.float32))


# ------------------------------------------------------- the tiny Llama
@pytest.fixture(scope="module")
def jax_llama():
    return JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=3)


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(5)
    ids = rs.randint(3, 128, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    return ids, mask


def _jax_quantized(jmodel, mode):
    """A JAX copy of `jmodel` quantized by its own quantize_ (which frees the
    kernels it replaces, so it works on a copy of the params)."""
    q = JLlamaForCausalLM(jmodel.config, params=jax.tree_util.tree_map(jnp.copy, jmodel.params))
    return q.quantize_(mode, min_bytes=0)


def _logits(jmodel, model, ids, mask):
    pos = np.where(mask > 0, np.cumsum(mask, -1) - 1, -1).astype(np.int32)
    jcache = jmodel.init_cache(2, 16)
    jlogits, jcache = jmodel(jnp.asarray(ids), jnp.asarray(pos), cache=jcache)
    tok = np.array([[7], [9]], np.int32)
    jstep, _ = jmodel(jnp.asarray(tok), jcache.lengths[:, None], cache=jcache)
    with torch.inference_mode():
        cache = model.init_cache(2, 16)
        logits, cache = model(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                              cache=cache)
        step, _ = model(torch.from_numpy(tok).long(), cache.lengths[:, None], cache=cache)
    valid = mask.astype(bool)
    return (np.asarray(jlogits)[valid], logits.numpy()[valid]), (np.asarray(jstep), step.numpy())


def _assert_close(ref, out, tol):
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("origin", ["jax_quantized", "port_quantized"])
@pytest.mark.parametrize("mode", ["a8w8", "a8w4", "wint4"])
def test_tiny_llama_matches_jax(jax_llama, prompts, mode, origin):
    """Once from the tree the JAX package quantized, carried across into a
    model built with quant set; once from the same bf16-path weights
    quantized by the port's own quantize_."""
    jq = _jax_quantized(jax_llama, mode)
    if origin == "jax_quantized":
        model = LlamaForCausalLM(LlamaConfig(**TINY, quant=mode)).eval()
        sd = flax_to_torch_state_dict(flatten_params(jq.params), model, LLAMA_KEY_MAP)
        assert sd["lm_head.kernel_q"].dtype == torch.int8
        model.load_state_dict(sd)
    else:
        model = LlamaForCausalLM(LlamaConfig(**TINY)).eval()
        model.load_state_dict(flax_to_torch_state_dict(flatten_params(jax_llama.params), model,
                                                       LLAMA_KEY_MAP))
        model.quantize_(mode)
        carried = flax_to_torch_state_dict(flatten_params(jq.params), model, LLAMA_KEY_MAP)
        for key, value in model.state_dict().items():  # the port's bytes are the JAX tree's
            if key.endswith("kernel_q"):
                assert torch.equal(value, carried[key]), key
    assert model.config.quant == mode
    ids, mask = prompts
    (jl, tl), (js, ts) = _logits(jq, model, ids, mask)
    _assert_close(jl, tl, LOGIT_TOL)
    _assert_close(js, ts, LOGIT_TOL)
    ref = np.asarray(jgreedy_generate(jq, jnp.asarray(ids), jnp.asarray(mask),
                                      max_new_tokens=NEW_TOKENS, eos_token_id=-1))
    out = greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tquant.a8w8_matmul.launches == tquant.a8w4_matmul.launches == 0  # plain on the CPU


# ------------------------------------------- config and in-place quantize
def test_config_takes_every_mode():
    for mode in QUANT_MODES:
        assert LlamaConfig.from_dict(dict(TINY, quant=mode)).quant == mode
    with pytest.raises(ValueError):
        LlamaConfig(quant="int3")
    model = LlamaForCausalLM(LlamaConfig(**TINY, quant="a8w4"))
    for name, m in model.named_modules():
        if isinstance(m, MXUDense):
            assert m.quant == "a8w4" and not hasattr(m, "weight"), name
            assert m.kernel_q.shape == (m.out_features, m.in_features // 2)
            assert m.kernel_q.dtype == torch.int8 and m.scale.dtype == torch.float32
    assert LlamaForCausalLM(LlamaConfig(**TINY, quant="a8w8")).lm_head.kernel_q.shape == (128, 128)


def test_quantize_frees_each_weight_in_place():
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    dense = [m for m in model.modules() if isinstance(m, MXUDense)]
    weights = sum(m.weight.numel() for m in dense)
    freed = model.quantize_("a8w4")
    assert freed == 4 * weights - weights // 2 - 4 * sum(m.out_features for m in dense)
    assert all(not hasattr(m, "weight") and m.quant == "a8w4" for m in dense)
    assert model.config.quant == model.model.config.quant == "a8w4"
    assert model.quantize_("a8w4") == 0
    with pytest.raises(ValueError):
        model.quantize_("a8w8")
    with pytest.raises(ValueError):
        LlamaForCausalLM(LlamaConfig(**TINY)).quantize_("int3")


def test_random_llava_quantizes_and_llava_config_records_it():
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                  num_attention_heads=2, image_size=28, patch_size=14)
    cfg = LlavaConfig(vision_config=vision, text_config=dict(TINY, vocab_size=64),
                      image_token_index=63)
    model = random_llava("cpu", torch.float32, seed=0, quant="a8w8", config=cfg)
    assert model.config.text.quant == "a8w8" and cfg.text.quant is None  # a copy
    dense = [m for m in model.language_model.modules() if isinstance(m, MXUDense)]
    assert len(dense) == 2 * 7 + 1 and all(m.quant == "a8w8" for m in dense)
    ids = torch.tensor([[5, 63, 63, 63, 63, 9, 11]])
    px = torch.randn(1, 28, 28, 3, generator=torch.Generator().manual_seed(0))
    out = model.generate(ids, px, max_new_tokens=3, eos_token_id=-1)
    assert out.shape == (1, 3) and ((out >= 0) & (out < 64)).all()


# -------------------------------------------------------------- plans
def _tiled_cases():
    shapes = [s for s in A8W_SHAPES if s[0] > 1] + [(100, 64, 24), (300, 352, 264)]
    return [("a8w8_dyn", s) for s in shapes + [A8W_RAGGED["a8w8"]]] + \
        [("a8w4", s) for s in shapes + [A8W_RAGGED["a8w4"]]]


@pytest.mark.parametrize("clusters", [gt.H100_CLUSTERS, 5], ids=["h100", "five_clusters"])
@pytest.mark.parametrize("kind, mkn", _tiled_cases(),
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in _tiled_cases()])
def test_walk_covers_every_tile_once(kind, mkn, clusters):
    m, k, n = mkn
    plan_fn = gt.a8w8_dyn_plan if kind == "a8w8_dyn" else gt.a8w4_plan
    for tile in (256, 128):
        plan = plan_fn(m, n, k, clusters, tiles=(tile,))
        assert plan.grid % gt.CLUSTER == 0 and plan.grid <= gt.CLUSTER * clusters
        real = [t for block in plan.walk() for t in block if plan.in_range(*t)]
        assert sorted(real) == [(o, i) for o in range(plan.outer_tiles)
                                for i in range(plan.inner_tiles)]
        covered = np.zeros((m, n), dtype=np.int32)
        for t in real:
            rows, cols = plan.region(*t)
            covered[rows, cols] += 1
        assert (covered == 1).all()
        # N1's stages are 64 deep in K, N2's 64 packed bytes (128 deep)
        assert plan.k_blocks == -(-k // (128 if kind == "a8w4" else 64))


def test_plans_and_layouts_as_the_library_answered():
    """(unit_inner, units, k_blocks, pair_inner, stages, shared memory) that
    csrc/a8w_gemm.cu's `a8w_gemm_plan` answered on an H100 80GB HBM3 (both
    tiles at each shape; chip_smoke.py holds the two equal there), mirrored
    here."""
    answered = {
        ("a8w8_dyn", 608, 4096, 11008, 256): (22, 110, 64, 1, 6, 216176),
        ("a8w8_dyn", 608, 4096, 11008, 128): (43, 215, 64, 1, 6, 134256),
        ("a8w8_dyn", 608, 11008, 4096, 256): (8, 40, 172, 1, 6, 216176),
        ("a8w8_dyn", 77, 4112, 4104, 128): (17, 17, 65, 1, 6, 134256),
        ("a8w4", 608, 4096, 11008, 256): (3, 129, 32, 0, 3, 191552),
        ("a8w4", 608, 4096, 11008, 128): (5, 215, 32, 0, 6, 183408),
        ("a8w4", 608, 11008, 4096, 256): (3, 48, 86, 0, 3, 191552),
        ("a8w4", 77, 4128, 4104, 256): (1, 17, 33, 0, 3, 191552),
    }
    for (kind, m, k, n, tile), fields in answered.items():
        plan_fn = gt.a8w8_dyn_plan if kind == "a8w8_dyn" else gt.a8w4_plan
        assert gt.a8w_plan_fields(plan_fn(m, n, k, tiles=(tile,))) == fields
    # the tiles the cost model picks on an H100 at the prefill's shapes
    for plan_fn in (gt.a8w8_dyn_plan, gt.a8w4_plan):
        assert [plan_fn(608, n, k).tile for k, n in ((4096, 11008), (11008, 4096))] == [256, 256]


def test_kernel_takes_and_refusals():
    assert tquant.a8w_kernel_takes("a8w8", 77, 4112, 4104)
    assert not tquant.a8w_kernel_takes("a8w4", 77, 4112, 4104)  # packed rows of 2,056 bytes
    assert tquant.a8w_kernel_takes("a8w4", 77, 4128, 4104)
    assert not tquant.a8w_kernel_takes("a8w8", 1, 4096, 4100)
    assert tquant.a8w_kernel_takes("a8w8", 1, 11008, 32000)
    assert not tquant.a8w_kernel_takes("a8w8", 1, 65536, 8)  # x's row past the GEMV's smem
    for fn in (tquant.a8w8_matmul, tquant.a8w4_matmul):
        with pytest.raises(ValueError):
            fn(torch.empty(1, 64, device="meta"), torch.empty(8, 64, dtype=torch.int8,
                                                              device="meta"),
               torch.empty(8, device="meta"))


# ------------------------------------------------------- the launch walk
@pytest.mark.parametrize("mode", ["a8w8", "a8w4", "wint4"])
def test_launch_walk_counts_n1_and_n2_on_meta(mode):
    with torch.device("meta"):
        model = LlavaForConditionalGeneration(llava7b_config())
    model.quantize_(mode)
    got = expected_launches_llava(model, 576 + 32, 128)
    n2 = mode in ("a8w4", "wint4")
    assert got["a8w4_matmul"] == (225 * 128 if n2 else 0)
    assert got["a8w8_matmul"] == (0 if n2 else 225 * 128)
    assert got["wint8_matmul"] == 0
    assert expected_launches_llava(model, 576 + 32, 1)["a8w4_matmul" if n2 else "a8w8_matmul"] \
        == 225
    # a model built with quant set walks the same
    cfg = llava7b_config()
    cfg = dataclasses.replace(cfg, text_config=dict(cfg.text_config, quant=mode))
    with torch.device("meta"):
        built = LlavaForConditionalGeneration(cfg)
    assert expected_launches_llava(built, 576 + 32, 128) == got
