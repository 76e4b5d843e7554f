"""The port's SD3 slice (paddlemix_tpu_torch.diffusers SD3 transformer,
FlowMatch pipeline, models.t5) against the JAX package on shared weights, in
fp32 on the CPU.

The JAX models are initialised by the JAX package, their parameters moved by
seeded noise (flax initialises every bias to 0), and carried over by
`diffusers.sd3.load_flax_sd3_pipeline` / `flax_to_torch_state_dict`, every key
consumed. The JAX side runs its Pallas kernels in interpret mode: widths of
128 and at least 64 rows, so that its adaLN, fused adaLN + residual and
RMSNorm take their kernels, and one case whose joint attention (256 image +
128 context tokens) takes flash on both sides. Compared: the transformer,
the T5 encoder, and the pipeline with and without T5 (latents, then image).
The launch derivation is checked against counted calls on a tiny pipeline
and at full width on the meta device.
"""

import numpy as np
import pytest
import torch

import jax
from paddlemix_tpu.diffusers import AutoencoderKL as JAutoencoderKL
from paddlemix_tpu.diffusers import AutoencoderKLConfig as JAutoencoderKLConfig
from paddlemix_tpu.diffusers import FlowMatchEulerDiscreteScheduler as JFlowMatch
from paddlemix_tpu.diffusers import SD3Transformer2DModel as JSD3
from paddlemix_tpu.diffusers import SD3TransformerConfig as JSD3Config
from paddlemix_tpu.diffusers import StableDiffusion3Pipeline as JPipeline
from paddlemix_tpu.models.t5 import T5Config as JT5Config
from paddlemix_tpu.models.t5 import T5EncoderModel as JT5
from paddlemix_tpu_torch.core import (
    SD3_KEY_MAP,
    T5_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    FlowMatchEulerDiscreteScheduler,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    StableDiffusion3Pipeline,
)
from paddlemix_tpu_torch.diffusers.sd3 import (
    SD3_SCHEDULER,
    SD3_TEXT_ENCODER,
    SD3_TEXT_ENCODER_2,
    SD3_TEXT_ENCODER_3,
    SD3_TRANSFORMER,
    SD3_VAE,
    expected_launches_sd3,
    load_flax_sd3_pipeline,
    random_sd3_pipeline,
    seeded_t5_tokenizer,
)
from paddlemix_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModelWithProjection,
    CLIPTokenizer,
)
from paddlemix_tpu_torch.models.clip.tokenizer import byte_level_tokenizer
from paddlemix_tpu_torch.models.t5 import T5Config, T5EncoderModel
from paddlemix_tpu_torch.ops import norms as tnorms
from test_pipelines import tiny_text_encoder, tiny_tokenizer
from test_torch_sdxl_modules import TINY_VAE

pytestmark = pytest.mark.torch_port

# 2 heads x 64: hidden 128, so JAX's adaLN kernels take rows of 128
TINY_SD3 = dict(sample_size=16, patch_size=2, in_channels=4, out_channels=4, num_layers=2,
                attention_head_dim=64, num_attention_heads=2, joint_attention_dim=128,
                pooled_projection_dim=32)
TINY_T5 = dict(vocab_size=64, d_model=128, d_kv=32, d_ff=192, num_layers=2, num_heads=4)
TINY_SD3_VAE = dict(TINY_VAE, scaling_factor=1.5305, shift_factor=0.0609)
T5_LEN = 24


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMIX_KERNEL_BACKEND", "pallas")
        mp.setenv("PMIX_PALLAS_INTERPRET", "1")
        yield


def _jittered(params, seed):
    """Every parameter moved by seeded noise, so that zero-initialised biases
    and the modulation layers are exercised."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32), params)


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _load(module, flax_params, key_map):
    module.load_state_dict(flax_to_torch_state_dict(flatten_flax(flax_params), module, key_map))
    return module.eval()


@pytest.fixture(scope="module")
def transformers():
    cfg = JSD3Config(**TINY_SD3)
    jmodel = JSD3(cfg, params=_jittered(JSD3.from_config(cfg, seed=0).params, 1))
    return jmodel, _load(SD3Transformer2DModel(SD3TransformerConfig(**TINY_SD3)), jmodel.params,
                         SD3_KEY_MAP)


# (latent side, context tokens): 64 image + 32 context tokens (math
# attention), and 256 + 128 = 384 (flash on both sides)
@pytest.mark.parametrize("case", [(16, 32), (32, 128)], ids=["math", "flash"])
def test_sd3_transformer_matches_jax(transformers, monkeypatch, case):
    side, ctx_len = case
    jmodel, model = transformers
    rs = np.random.RandomState(side)
    lat = rs.randn(2, side, side, 4).astype(np.float32)
    ctx = rs.randn(2, ctx_len, 128).astype(np.float32)
    pooled = rs.randn(2, 32).astype(np.float32)
    t = np.array([980.0, 3.5], np.float32)
    from paddlemix_tpu.ops import norms as jnorms

    kernels = set()  # the Pallas kernel functions JAX ran, by name
    pallas_call = jnorms.pl.pallas_call
    monkeypatch.setattr(jnorms.pl, "pallas_call", lambda kernel, *a, **kw: kernels.add(
        getattr(kernel, "func", kernel).__name__) or pallas_call(kernel, *a, **kw))
    ref = jmodel(*(jax.numpy.asarray(a) for a in (lat, t, ctx, pooled)))
    assert {"_adaln_kernel", "_fused_adaln_residual_kernel"} <= kernels
    assert ("_fwd_kernel" in kernels) == (side == 32), kernels  # flash
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (lat, t, ctx, pooled)))
    assert out.dtype == torch.float32
    _assert_close(ref, out, 1e-4)


@pytest.fixture(scope="module")
def jax_t5():
    cfg = JT5Config(**TINY_T5)
    return JT5(cfg, params=_jittered(JT5.from_config(cfg, seed=0).params, 2))


def test_t5_encoder_matches_jax(jax_t5):
    jmodel = jax_t5
    model = _load(T5EncoderModel(T5Config(**TINY_T5)), jmodel.params, T5_KEY_MAP)
    ids = np.random.RandomState(3).randint(0, 64, size=(2, 77)).astype(np.int32)
    ref_x, ref_mean = jmodel(jax.numpy.asarray(ids))
    with torch.no_grad():
        x, mean = model(torch.from_numpy(ids).long())
    _assert_close(ref_x, x, 1e-4)
    _assert_close(ref_mean, mean, 1e-4)
    assert tnorms.rms_norm.launches == 0


def test_weight_carrying_consumes_every_key(transformers, jax_t5):
    jmodel, model = transformers
    flat = flatten_flax(jmodel.params)
    sd = flax_to_torch_state_dict(flat, model, SD3_KEY_MAP)
    assert len(sd) == len(flat) == len(model.state_dict())
    # the fused q/k/v kernels are (in, 3 * out) in flax and transposed
    fkey = "transformer_blocks_1.attn_add_qkv.kernel"
    np.testing.assert_array_equal(sd["transformer_blocks.1.attn_add_qkv.weight"].numpy(),
                                  np.asarray(flat[fkey]).T)
    assert tuple(sd["transformer_blocks.0.attn_qkv.weight"].shape) == (384, 128)
    # T5's relative bias table is an nn.Embed: (buckets, heads), not transposed
    t5 = T5EncoderModel(T5Config(**TINY_T5))
    flat = flatten_flax(jax_t5.params)
    sd = flax_to_torch_state_dict(flat, t5, T5_KEY_MAP)
    assert len(sd) == len(flat)
    np.testing.assert_array_equal(
        sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].numpy(),
        np.asarray(flat["block_0.attention.relative_attention_bias.embedding"]))
    np.testing.assert_array_equal(sd["shared.weight"].numpy(),
                                  np.asarray(flat["shared.embedding"]))
    # a leftover flax key, or a second table that claims `shared`, raises
    with pytest.raises(KeyError, match="unused"):
        flax_to_torch_state_dict(dict(flat, extra=np.zeros(1)), t5, T5_KEY_MAP)
    t5.encoder.embed_tokens = t5.shared
    with pytest.raises(KeyError, match="claimed by both"):
        flax_to_torch_state_dict(flat, t5, T5_KEY_MAP)


def _port_pipeline(jpipe, jtok):
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    text_cfg = CLIPTextConfig(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=16, eos_token_id=tok.eos_token_id,
                              projection_dim=16)
    with_t5 = jpipe.text_encoder_3 is not None
    pipe = StableDiffusion3Pipeline(
        transformer=SD3Transformer2DModel(SD3TransformerConfig(**TINY_SD3)),
        scheduler=FlowMatchEulerDiscreteScheduler(**SD3_SCHEDULER),
        vae=AutoencoderKL(AutoencoderKLConfig(**TINY_SD3_VAE)),
        text_encoder=CLIPTextModelWithProjection(text_cfg), tokenizer=tok,
        text_encoder_2=CLIPTextModelWithProjection(text_cfg), tokenizer_2=tok,
        text_encoder_3=T5EncoderModel(T5Config(**TINY_T5)) if with_t5 else None,
        tokenizer_3=jpipe.tokenizer_3)
    names = ("transformer", "vae", "text_encoder", "text_encoder_2") + \
        (("text_encoder_3",) if with_t5 else ())
    return load_flax_sd3_pipeline(pipe, {n: getattr(jpipe, n).params for n in names})


@pytest.fixture(scope="module", params=[True, False], ids=["t5", "no_t5"])
def pipes(request, transformers, jax_t5):
    jtok = tiny_tokenizer()
    t5 = jax_t5 if request.param else None
    jpipe = JPipeline(
        transformer=transformers[0], scheduler=JFlowMatch(shift=3.0),
        vae=JAutoencoderKL.from_config(JAutoencoderKLConfig(**TINY_SD3_VAE), seed=0),
        text_encoder=tiny_text_encoder(jtok, with_projection=True, dim=16), tokenizer=jtok,
        text_encoder_2=tiny_text_encoder(jtok, with_projection=True, dim=16), tokenizer_2=jtok,
        text_encoder_3=t5,
        tokenizer_3=seeded_t5_tokenizer(0, vocab_size=64, length=T5_LEN) if t5 else None)
    latents = np.random.RandomState(5).randn(1, 16, 16, 4).astype(np.float32)
    return jpipe, _port_pipeline(jpipe, jtok), latents


CALL = dict(prompt="a photo of a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=2, guidance_scale=7.0)


def test_sd3_pipeline_latents_match_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = np.asarray(jpipe(**CALL, latents=latents, output_type="latent")[0])
    out = pipe(**CALL, latents=latents, output_type="latent")[0]
    assert out.dtype == torch.float32 and tuple(out.shape) == latents.shape
    _assert_close(ref, out, 1e-4)


def test_sd3_pipeline_image_matches_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = jpipe(**CALL, latents=latents, output_type="np")[0]
    out = pipe(**CALL, latents=torch.from_numpy(latents), output_type="np")[0]
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert tnorms.adaptive_layer_norm.launches == tnorms.fused_adaln_scale_residual.launches == 0


def test_load_flax_sd3_pipeline_needs_every_component(pipes):
    jpipe, pipe, _ = pipes
    given = {n: getattr(jpipe, n).params for n in ("transformer", "vae", "text_encoder")}
    with pytest.raises(KeyError, match="text_encoder_2"):
        load_flax_sd3_pipeline(pipe, given)


def test_random_pipeline_launches_match_walk(monkeypatch):
    """Calls of each kernel wrapper, counted on the CPU where the kernels'
    own counters stay 0, against `expected_launches_sd3`."""
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod
    from paddlemix_tpu_torch.diffusers.models import transformer_sd3 as sd3_mod
    from paddlemix_tpu_torch.models import layers as layers_mod
    from paddlemix_tpu_torch.models.t5 import modeling as t5_mod
    from paddlemix_tpu_torch.ops import attention as attn_mod

    counts = {}

    def count(mod, name):
        fn = getattr(mod, name)
        counts[name] = 0

        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((sd3_mod, "adaptive_layer_norm"), (sd3_mod, "fused_adaln_scale_residual"),
                      (attn_mod, "flash_attention"), (resnet_mod, "group_norm"),
                      (t5_mod, "rms_norm"), (layers_mod, "layer_norm")):
        count(mod, name)
    tok = byte_level_tokenizer(model_max_length=16)
    text = dict(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2, projection_dim=16)
    pipe = random_sd3_pipeline("cpu", torch.float32, seed=0, transformer=TINY_SD3,
                               vae=TINY_SD3_VAE, text_encoder=dict(text, hidden_act="quick_gelu"),
                               text_encoder_2=dict(text, hidden_act="gelu"),
                               text_encoder_3=TINY_T5, tokenizer=tok,
                               tokenizer_3=seeded_t5_tokenizer(0, vocab_size=64, length=88))
    image = pipe("a cat", height=64, width=64, num_inference_steps=2, seed=1,
                 output_type="np")[0]
    assert image.shape == (1, 64, 64, 3) and np.isfinite(image).all()
    expected = expected_launches_sd3(pipe, 64, 64, 2, guidance_scale=7.0)
    # 256 + 16 + 88 = 360 joint tokens: not a multiple of 128 and under 1024, so
    # math; the VAE's 1024-token, 16-wide head takes flash once; each 2-layer
    # CLIP tower's 5 LayerNorms run for the prompt and the negative prompt
    assert expected == {"adaptive_layer_norm": 5 * 2, "fused_adaln_scale_residual": 3 * 2,
                        "flash_attention": 1, "group_norm": 14, "rms_norm": 2 * 5,
                        "layer_norm": 2 * (5 + 5)}
    assert counts == expected


def test_expected_launches_full_width_sd3():
    tok = byte_level_tokenizer()
    with torch.device("meta"):  # shapes only: nothing of the model's size is allocated
        clip = [CLIPTextModelWithProjection(CLIPTextConfig(**c, eos_token_id=tok.eos_token_id))
                for c in (SD3_TEXT_ENCODER, SD3_TEXT_ENCODER_2)]
        pipe = StableDiffusion3Pipeline(
            transformer=SD3Transformer2DModel(SD3TransformerConfig(**SD3_TRANSFORMER)),
            scheduler=FlowMatchEulerDiscreteScheduler(**SD3_SCHEDULER),
            vae=AutoencoderKL(AutoencoderKLConfig(**SD3_VAE)),
            text_encoder=clip[0], tokenizer=tok, text_encoder_2=clip[1], tokenizer_2=tok,
            text_encoder_3=T5EncoderModel(T5Config(**SD3_TEXT_ENCODER_3)),
            tokenizer_3=seeded_t5_tokenizer(0))
    n = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
         for name in ("transformer", "text_encoder_3")}
    assert 2.02e9 < n["transformer"] < 2.04e9  # SD3-medium MM-DiT: 2.028 B parameters
    assert 4.75e9 < n["text_encoder_3"] < 4.77e9  # T5 v1.1-XXL encoder: 4.762 B
    # per request (28 steps, CFG batch 2): 49 adaLN and 47 fused adaLN +
    # residual a forward; 24 joint attentions over 4096 + 77 + 77 = 4,250
    # tokens, flash; 49 T5 RMSNorms for each of the two prompts; the VAE
    # decoder's 30 GroupNorms (its 16,384-token 512-wide head is math); the
    # CLIP-L and bigG towers' 25 and 65 LayerNorms for each of the two prompts
    assert expected_launches_sd3(pipe, 1024, 1024, 28) == {
        "adaptive_layer_norm": 1372, "fused_adaln_scale_residual": 1316,
        "flash_attention": 672, "rms_norm": 98, "group_norm": 30, "layer_norm": 180}
