"""The static-a8w8 SDXL path of the port against the JAX package: the scale
scope's call order and values, the quantized resnet (fused path), spatial
transformer, UNet and VAE decoder, the tiny pipeline, and the op counts at
full SDXL width.

Weights come from the JAX modules' seeded init and are carried over with
`flax_to_torch_state_dict`; inputs are made with numpy. Everything runs in
fp32 on the CPU. The port is given the scales the JAX package recorded, so
both sides quantize with the same sx; what is left is fp32 summation order,
which moves a quantized value across a rounding boundary only rarely."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import EulerDiscreteScheduler as JEuler
from paddlemix_tpu.diffusers import StableDiffusionXLPipeline as JPipeline
from paddlemix_tpu.diffusers.models import AutoencoderKL as JAutoencoderKL
from paddlemix_tpu.diffusers.models import AutoencoderKLConfig as JAutoencoderKLConfig
from paddlemix_tpu.diffusers.models import UNet2DConditionConfig as JUNetConfig
from paddlemix_tpu.diffusers.models import UNet2DConditionModel as JUNet
from paddlemix_tpu.diffusers.models import attention as jattn_mod
from paddlemix_tpu.diffusers.models import resnet as jresnet
from paddlemix_tpu.ops.quant import static_a8w8_scope as jscope
from paddlemix_tpu_torch.core import CLIP_KEY_MAP, UNET_KEY_MAP, VAE_KEY_MAP, \
    flax_to_torch_state_dict
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    EulerDiscreteScheduler,
    StableDiffusionXLPipeline,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers.models import ResnetBlock2D, Transformer2DModel
from paddlemix_tpu_torch.diffusers.sdxl import byte_level_tokenizer, calibrate_static_a8w8, \
    expected_launches, random_sdxl_pipeline, record_static_a8w8
from paddlemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, \
    CLIPTextModelWithProjection, CLIPTokenizer
from paddlemix_tpu_torch.ops import conv_int8 as tci
from paddlemix_tpu_torch.ops import fused_resnet as tfr
from paddlemix_tpu_torch.ops import quant as tquant
from paddlemix_tpu_torch.ops.quant import QuantConv2d, load_static_scales, quant_modules, \
    static_a8w8_scope
from test_pipelines import tiny_text_encoder, tiny_tokenizer
from test_torch_sdxl_modules import TINY_UNET_SDXL, TINY_VAE

pytestmark = pytest.mark.torch_port

A8W8 = dict(quant="a8w8_static")
CALL = dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=2, guidance_scale=5.0)


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _port(module, flax_params, key_map):
    module.load_state_dict(flax_to_torch_state_dict(flatten_params(flax_params), module,
                                                    key_map))
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_record(fn):
    """Run `fn` under the JAX record scope; the raw absmax list as floats."""
    with jscope("record") as ctx:
        fn()
    return [float(s) for s in ctx.scales]


def _port_record(fn):
    with static_a8w8_scope() as rec:
        with torch.no_grad():
            fn()
    return rec


def _same_scales(jax_raw, rec):
    """The port records as many scales as JAX, in the same order: fp32 absmax
    of activations that agree to summation order."""
    assert len(rec.modules) == len(jax_raw)
    np.testing.assert_allclose(rec.raw(), jax_raw, rtol=1e-5)


# ----------------------------------------------------------- resnet (fused)
def test_resnet_block_fused_matches_jax_fused_and_unfused(monkeypatch):
    rs = np.random.RandomState(0)
    x = rs.randn(1, 4, 16, 128).astype(np.float32)
    temb = rs.randn(1, 64).astype(np.float32)
    jm = jresnet.ResnetBlock2D(out_channels=256, groups=32, quant="a8w8_static")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb))
    jax_raw = _jax_record(lambda: jm.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    with jscope("apply", jax_raw):
        ref_unfused = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))
    monkeypatch.setenv("PMIX_FUSED_RESNET", "1")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")  # the fused Pallas kernel, interpreted
    with jscope("apply", jax_raw):
        ref_fused = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))

    tm = _port(ResnetBlock2D(128, 256, 64, groups=32, quant=True), params["params"],
               UNET_KEY_MAP)
    rec = _port_record(lambda: tm(_nchw(x), torch.from_numpy(temb)))
    assert rec.modules == [tm.conv1, tm.conv2, tm.conv_shortcut]  # the JAX consumption order
    _same_scales(jax_raw, rec)
    load_static_scales(rec.modules, jax_raw)
    assert tm.fused
    with torch.no_grad():
        out = _nhwc(tm(_nchw(x), torch.from_numpy(temb)))
    # a step of one quantized value moves an output by <= sx * |w|max ~ 2e-3
    # here; fp32 summation order makes such steps rare
    _assert_close(ref_fused, out, tol=1e-4)
    _assert_close(ref_unfused, out, tol=1e-4)
    assert tfr.fused_gn_silu_conv3x3.launches == 0  # CPU: the plain version


# -------------------------------------------------------------- transformer
@pytest.mark.parametrize("linear", [True, False], ids=["linear_proj", "conv_proj"])
def test_transformer2d_a8w8_matches_jax(linear):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    ctx = rs.randn(2, 5, 12).astype(np.float32)
    jm = jattn_mod.Transformer2DModel(num_heads=2, head_dim=8, num_layers=2,
                                      use_linear_projection=linear, groups=4,
                                      quant="a8w8_static")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ctx))
    jax_raw = _jax_record(lambda: jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    with jscope("apply", jax_raw):
        ref = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tm = _port(Transformer2DModel(16, 2, 8, cross_dim=12, num_layers=2,
                                  use_linear_projection=linear, groups=4, quant=True),
               params["params"], UNET_KEY_MAP)
    rec = _port_record(lambda: tm(_nchw(x), torch.from_numpy(ctx)))
    # proj_in, 2 x (attn1 q/k/v/out, attn2 q/k/v/out, ff proj, ff net.2), proj_out
    assert len(rec.modules) == 1 + 2 * 10 + 1
    assert rec.modules[0] is tm.proj_in and rec.modules[-1] is tm.proj_out
    assert isinstance(tm.proj_in, QuantConv2d) != linear
    _same_scales(jax_raw, rec)
    load_static_scales(rec.modules, jax_raw)
    with torch.no_grad():
        out = _nhwc(tm(_nchw(x), torch.from_numpy(ctx)))
    _assert_close(ref, out, tol=1e-4)


# ----------------------------------------------------------- UNet and VAE
def _jit_from_config(cls, config):
    """`cls.from_config(config)` with its init traced once by jit instead of
    run op by op (the same seed-0 parameters, in a fraction of the time)."""
    module = cls.module_class(config)
    args, kwargs = cls.example_inputs(config)
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))()
    return cls(config, module, dict(params["params"]))


@pytest.fixture(scope="module")
def jax_a8w8():
    jtok = tiny_tokenizer()
    return dict(tok=jtok,
                unet=_jit_from_config(JUNet, JUNetConfig.from_dict(dict(TINY_UNET_SDXL, **A8W8))),
                vae=_jit_from_config(JAutoencoderKL, JAutoencoderKLConfig(**TINY_VAE, **A8W8)),
                te1=tiny_text_encoder(jtok, dim=16),
                te2=tiny_text_encoder(jtok, with_projection=True, dim=16))


def _unet_inputs():
    rs = np.random.RandomState(2)
    return dict(sample=rs.randn(2, 8, 8, 4).astype(np.float32),
                t=np.asarray([700.0, 700.0], np.float32),
                ctx=rs.randn(2, 6, 32).astype(np.float32),
                added={"text_embeds": rs.randn(2, 16).astype(np.float32),
                       "time_ids": np.tile(np.asarray([[32, 32, 0, 0, 32, 32]], np.float32),
                                           (2, 1))})


def _torch_unet_inputs(inp):
    return (torch.from_numpy(inp["sample"]), torch.from_numpy(inp["t"]),
            torch.from_numpy(inp["ctx"]),
            {k: torch.from_numpy(v) for k, v in inp["added"].items()})


def test_unet_a8w8_matches_jax_and_reuses_scales(jax_a8w8):
    ju, inp = jax_a8w8["unet"], _unet_inputs()
    jargs = (jnp.asarray(inp["sample"]), jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"]))
    jadded = {k: jnp.asarray(v) for k, v in inp["added"].items()}

    def apply(p):
        return ju.module.apply({"params": p}, *jargs, added_cond_kwargs=jadded)

    def calib(p):
        with jscope("record") as ctx:
            apply(p)
        return jnp.stack(ctx.scales)

    jax_raw = [float(v) for v in np.asarray(jax.jit(calib)(ju.params))]
    with jscope("apply", jax_raw):
        ref = jax.jit(apply)(ju.params)
    tu = _port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL, **A8W8)), ju.params,
               UNET_KEY_MAP)
    args = _torch_unet_inputs(inp)
    rec = _port_record(lambda: tu(*args[:3], added_cond_kwargs=args[3]))
    assert len(rec.modules) == len(quant_modules(tu))  # every quantized op, once
    _same_scales(jax_raw, rec)
    load_static_scales(rec.modules, jax_raw)
    with torch.no_grad():
        out = tu(*args[:3], added_cond_kwargs=args[3])
        again = tu(*args[:3], added_cond_kwargs=args[3])
    _assert_close(ref, out, tol=1e-4)
    assert torch.equal(out, again)  # every forward reuses the scales loaded once


def test_uncalibrated_a8w8_unet_is_the_plain_unet(jax_a8w8):
    ju, inp = jax_a8w8["unet"], _unet_inputs()
    plain = _port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL)), ju.params,
                  UNET_KEY_MAP)
    quant = _port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL, **A8W8)),
                  ju.params, UNET_KEY_MAP)
    assert quant.state_dict().keys() == plain.state_dict().keys()  # int8 buffers not saved
    args = _torch_unet_inputs(inp)
    with torch.no_grad():
        assert torch.equal(quant(*args[:3], added_cond_kwargs=args[3]),
                           plain(*args[:3], added_cond_kwargs=args[3]))


def _vae_decode_params(vae):
    return dict(vae.params)  # the port's VAE holds the encoder too


def test_vae_decoder_a8w8_matches_jax(jax_a8w8):
    jv = jax_a8w8["vae"]
    z = np.random.RandomState(3).randn(1, 4, 4, 4).astype(np.float32)

    def decode(p):
        return jv.module.apply({"params": p}, jnp.asarray(z), method=jv.module.decode)

    jax_raw = _jax_record(lambda: decode(jv.params))
    with jscope("apply", jax_raw):
        ref = decode(jv.params)
    tv = _port(AutoencoderKL(AutoencoderKLConfig(**TINY_VAE, **A8W8)), _vae_decode_params(jv),
               VAE_KEY_MAP)
    rec = _port_record(lambda: tv.decode(torch.from_numpy(z)))
    # mid 2 resnets x 2 convs, 2 up blocks x 2 resnets x 2 convs, 1 shortcut, 1 up-sample
    assert len(rec.modules) == len(quant_modules(tv)) == 4 + 8 + 1 + 1
    _same_scales(jax_raw, rec)
    load_static_scales(rec.modules, jax_raw)
    with torch.no_grad():
        out = tv.decode(torch.from_numpy(z))
    _assert_close(ref, out, tol=1e-4)


# ----------------------------------------------------------------- pipeline
def _pipelines(j):
    tok = CLIPTokenizer(j["tok"].encoder, [], model_max_length=j["tok"].model_max_length)
    text_cfg = CLIPTextConfig(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=16, eos_token_id=tok.eos_token_id,
                              projection_dim=16)
    pipe = StableDiffusionXLPipeline(
        vae=_port(AutoencoderKL(AutoencoderKLConfig(**TINY_VAE, **A8W8)),
                  _vae_decode_params(j["vae"]), VAE_KEY_MAP),
        text_encoder=_port(CLIPTextModel(text_cfg), j["te1"].params, CLIP_KEY_MAP),
        text_encoder_2=_port(CLIPTextModelWithProjection(text_cfg), j["te2"].params,
                             CLIP_KEY_MAP),
        tokenizer=tok, tokenizer_2=tok,
        unet=_port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL, **A8W8)),
                   j["unet"].params, UNET_KEY_MAP),
        scheduler=EulerDiscreteScheduler())

    def jax_pipe():  # a fresh pipeline: its jit cache traces inside the scope it is called in
        return JPipeline(vae=j["vae"], text_encoder=j["te1"], text_encoder_2=j["te2"],
                         tokenizer=j["tok"], tokenizer_2=j["tok"], unet=j["unet"],
                         scheduler=JEuler())

    return jax_pipe, pipe


def _jax_calibration(jpipe, latents):
    """The JAX bench's calibration (bench.py), on the pipeline's encoded
    prompt: one UNet forward at timesteps[0] on the CFG-doubled initial noise,
    then one VAE decode of the noise / scaling_factor, UNet scales first."""
    cond, uncond, pooled, neg_pooled = jpipe.encode_prompt(CALL["prompt"],
                                                           CALL["negative_prompt"])
    state = JEuler().set_timesteps(CALL["num_inference_steps"])
    time_ids = jnp.tile(jnp.asarray([[32, 32, 0, 0, 32, 32]], jnp.float32), (2, 1))
    lat = jnp.asarray(latents)
    unet, vae = jpipe.unet, jpipe.vae

    def calib(unet_params, vae_params):
        with jscope("record") as ctx:
            unet.module.apply(
                {"params": unet_params}, jnp.concatenate([lat, lat]),
                jnp.broadcast_to(state.timesteps[0], (2,)), jnp.concatenate([uncond, cond]),
                added_cond_kwargs={"text_embeds": jnp.concatenate([neg_pooled, pooled]),
                                   "time_ids": time_ids})
            vae.module.apply({"params": vae_params}, lat / vae.config.scaling_factor,
                             method=vae.module.decode)
        return jnp.stack(ctx.scales)

    return [float(v) for v in np.asarray(jax.jit(calib)(unet.params, vae.params))]


def test_sdxl_a8w8_pipeline_matches_jax(jax_a8w8):
    jax_pipe, pipe = _pipelines(jax_a8w8)
    latents = np.random.RandomState(0).randn(1, 32 // pipe.vae_scale_factor,
                                             32 // pipe.vae_scale_factor, 4).astype(np.float32)
    jax_raw = _jax_calibration(jax_pipe(), latents)
    n_unet = len(quant_modules(pipe.unet))
    assert len(jax_raw) == n_unet + len(quant_modules(pipe.vae))
    rec = record_static_a8w8(pipe, CALL["prompt"], 32, 32, CALL["num_inference_steps"],
                             CALL["guidance_scale"], CALL["negative_prompt"],
                             latents=torch.from_numpy(latents))
    np.testing.assert_allclose(rec.raw(), jax_raw, rtol=1e-5)  # same values, same order
    load_static_scales(rec.modules, jax_raw)
    assert [m.sx for m in quant_modules(pipe.unet)][:1] == [tquant.static_scale(jax_raw[0])]
    jpipe = jax_pipe()
    with jscope("apply", jax_raw):  # the denoise trace consumes the UNet's scales
        ref = jpipe(**CALL, latents=latents, output_type="latent")[0]
    out = pipe(**CALL, latents=latents, output_type="latent")[0]
    # fp32 on both sides. A value that lands within fp32 rounding of an int8
    # rounding boundary may round the other way in the other framework (its
    # sums run in another order); one such step, carried through 2 steps of
    # the UNet, moves a few latents by up to ~2e-3 of the largest
    _assert_close(ref, out, tol=5e-3)
    # the decode of the same latents on both sides; its trace consumes the VAE's scales
    with jscope("apply", jax_raw[n_unet:]):
        ref_img = jpipe.image_processor.postprocess(jpipe._decode_latents(ref), "np")
    with torch.no_grad():
        img = pipe.image_processor.postprocess(
            pipe._decode_latents(torch.from_numpy(np.asarray(ref))), "np")
    assert img.shape == (1, 32, 32, 3) and np.isfinite(img).all()
    _assert_close(ref_img, img, tol=5e-3)
    assert tci.int8_a8w8_matmul.launches == tci.int8_conv3x3_same.launches == 0


def _counting(monkeypatch):
    """Count the calls of every wrapper the a8w8 path reaches, on the CPU."""
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod
    from paddlemix_tpu_torch.models import layers as layers_mod
    from paddlemix_tpu_torch.ops import attention as attn_mod

    counts = {}

    def wrap(mod, name):
        fn = getattr(mod, name)
        counts[name] = 0

        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)

    wrap(attn_mod, "flash_attention")
    wrap(resnet_mod, "group_norm")
    wrap(tfr, "group_norm_stats")
    wrap(tquant, "int8_a8w8_matmul")
    wrap(tquant, "int8_conv3x3_same")
    wrap(resnet_mod, "fused_gn_silu_conv3x3")
    wrap(layers_mod, "layer_norm")  # the text towers' LayerNorms (B10)
    return counts


def test_a8w8_pipeline_launches_match_walk(monkeypatch):
    tok = byte_level_tokenizer(model_max_length=16)
    text = dict(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2, projection_dim=16)
    pipe = random_sdxl_pipeline("cpu", torch.float32, seed=0, unet=TINY_UNET_SDXL, vae=TINY_VAE,
                                text_encoder=dict(text, hidden_act="quick_gelu"),
                                text_encoder_2=dict(text, hidden_act="gelu"), tokenizer=tok,
                                quant="a8w8_static")
    raw = calibrate_static_a8w8(pipe, "a cat", 32, 32, 2, 5.0, seed=1)
    assert len(raw) == len(quant_modules(pipe.unet)) + len(quant_modules(pipe.vae))
    counts = _counting(monkeypatch)
    tci.int8_conv2d_plain.calls = 0
    image = pipe("a cat", height=32, width=32, num_inference_steps=2, guidance_scale=5.0,
                 seed=1, output_type="np")[0]
    assert image.shape == (1, 32, 32, 3) and np.isfinite(image).all()
    counts["int8_conv2d_plain"] = tci.int8_conv2d_plain.calls
    expected = expected_launches(pipe, 32, 32, 2, guidance_scale=5.0)
    assert expected == counts
    # the tiny UNet has one down-sample conv, the tiny VAE one up-sample conv
    assert expected["int8_conv2d_plain"] == 2 and expected["int8_conv3x3_same"] == 2 + 1


def test_full_width_sdxl_a8w8_counts():
    from paddlemix_tpu_torch.diffusers.sdxl import (
        SDXL_SCHEDULER,
        SDXL_TEXT_ENCODER,
        SDXL_TEXT_ENCODER_2,
        SDXL_UNET,
        SDXL_VAE,
    )

    tok = byte_level_tokenizer()
    with torch.device("meta"):  # shapes only: nothing of the model's size is allocated
        pipe = StableDiffusionXLPipeline(
            vae=AutoencoderKL(AutoencoderKLConfig(**SDXL_VAE, **A8W8)),
            text_encoder=CLIPTextModel(CLIPTextConfig(**SDXL_TEXT_ENCODER,
                                                      eos_token_id=tok.eos_token_id)),
            text_encoder_2=CLIPTextModelWithProjection(
                CLIPTextConfig(**SDXL_TEXT_ENCODER_2, eos_token_id=tok.eos_token_id)),
            tokenizer=tok, tokenizer_2=tok,
            unet=UNet2DConditionModel(UNet2DConditionConfig(**SDXL_UNET, **A8W8)),
            scheduler=EulerDiscreteScheduler(**SDXL_SCHEDULER))
    assert len(quant_modules(pipe.unet)) == 771  # the JAX bench's 771-op calibration
    assert len(quant_modules(pipe.vae)) == 33
    # no scales loaded: the bf16 path and its counts; the text towers' 25 and
    # 65 LayerNorms run for the prompt and the negative prompt
    assert expected_launches(pipe, 1024, 1024, 25) == {"flash_attention": 1750,
                                                       "group_norm": 1180, "layer_norm": 180}
    # any scales (call order does not matter for the counts): the a8w8 routing
    modules = quant_modules(pipe.unet) + quant_modules(pipe.vae)
    load_static_scales(modules, [1.0] * len(modules))
    assert expected_launches(pipe, 1024, 1024, 25) == {
        "flash_attention": 1750, "layer_norm": 180, "group_norm": 12 * 25 + 2,
        "group_norm_stats": 878,
        "int8_a8w8_matmul": 733 * 25 + 2, "fused_gn_silu_conv3x3": 34 * 25 + 28,
        "int8_conv3x3_same": 2 * 25 + 3, "int8_conv2d_plain": 2 * 25}
