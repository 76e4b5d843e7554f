"""SDXL modules of the port against their JAX twins on shared weights.

Weights come from the JAX modules' seeded init and are carried over with
`flax_to_torch_state_dict`; inputs are made with numpy. Everything runs in
fp32 on the CPU, so the tolerances cover summation order only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers.models import attention as jattn_mod
from paddlemix_tpu.diffusers.models import resnet as jresnet
from paddlemix_tpu.diffusers.schedulers import EulerDiscreteScheduler as JEuler
from paddlemix_tpu.ops import activations as jact
from paddlemix_tpu_torch.core import (
    CLIP_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    flax_to_torch_state_dict,
    torch_key_to_flax,
)
from paddlemix_tpu_torch.diffusers.models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    GEGLUFeedForward,
    ResnetBlock2D,
    Transformer2DModel,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers.schedulers import EulerDiscreteScheduler
from paddlemix_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextModelWithProjection,
)
from paddlemix_tpu_torch.ops import activations as tact
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae

pytestmark = pytest.mark.torch_port

TINY_UNET_SDXL = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8,
    addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=16 + 6 * 8,
)
TINY_VAE = dict(block_out_channels=(8, 16), down_block_types=("DownEncoderBlock2D",) * 2,
                up_block_types=("UpDecoderBlock2D",) * 2, layers_per_block=1,
                latent_channels=4, norm_num_groups=4)


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


def _vae_decode_params(vae):
    return dict(vae.params)  # the port's VAE holds the encoder too


@pytest.fixture(scope="module")
def jax_models():
    tok = tiny_tokenizer()
    return dict(tok=tok, unet=tiny_unet(ctx_dim=32, sdxl=True), vae=tiny_vae(),
                te1=tiny_text_encoder(tok, dim=16),
                te2=tiny_text_encoder(tok, with_projection=True, dim=16))


def _text_config(tok, dim=16):
    return CLIPTextConfig(vocab_size=tok.vocab_size, hidden_size=dim, intermediate_size=dim * 2,
                          num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
                          eos_token_id=tok.eos_token_id, projection_dim=dim)


# ----------------------------------------------------------------- conversion
@pytest.mark.parametrize("name", ["unet", "vae", "te1", "te2"])
def test_conversion_consumes_every_jax_key_once(jax_models, name):
    m = jax_models[name]
    tok = jax_models["tok"]
    if name == "unet":
        module, params, key_map = (UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL)),
                                   m.params, UNET_KEY_MAP)
    elif name == "vae":  # the port has the decode path only
        module, params, key_map = (AutoencoderKL(AutoencoderKLConfig(**TINY_VAE)),
                                   _vae_decode_params(m), VAE_KEY_MAP)
    else:
        cls = CLIPTextModel if name == "te1" else CLIPTextModelWithProjection
        module, params, key_map = cls(_text_config(tok)), m.params, CLIP_KEY_MAP
    flat = flatten_params(params)
    sd = flax_to_torch_state_dict(flat, module, key_map)  # raises on any leftover key
    mapped = [torch_key_to_flax(k, key_map) for k in module.state_dict()]
    assert sorted(mapped) == sorted(flat) and len(set(mapped)) == len(mapped)
    assert set(sd) == set(module.state_dict())
    if name == "unet":
        assert "time_embedding.linear_1.kernel" in flat
        assert "add_embedding.linear_1.kernel" in flat
        assert any(k.endswith("attn1.to_out.kernel") for k in flat)
        np.testing.assert_array_equal(sd["time_embedding.linear_1.weight"].numpy(),
                                      np.asarray(flat["time_embedding.linear_1.kernel"]).T)


def test_conversion_raises_on_leftover_key(jax_models):
    flat = flatten_params(jax_models["unet"].params)
    flat["extra.kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="extra.kernel"):
        flax_to_torch_state_dict(flat, UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL)),
                                 UNET_KEY_MAP)


# ------------------------------------------------------------------- modules
@pytest.mark.parametrize("cin,cout,temb", [(8, 16, True), (16, 16, False)])
def test_resnet_block_parity(cin, cout, temb):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, cin).astype(np.float32)
    t = rs.randn(2, 32).astype(np.float32) if temb else None
    jm = jresnet.ResnetBlock2D(out_channels=cout, groups=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), None if t is None else jnp.asarray(t))
    ref = jm.apply(params, jnp.asarray(x), None if t is None else jnp.asarray(t))
    tm = _port(ResnetBlock2D(cin, cout, 32 if temb else None, groups=4), params["params"],
               UNET_KEY_MAP)
    out = tm(_nchw(x), None if t is None else torch.from_numpy(t))
    _assert_close(ref, _nhwc(out), tol=1e-5)


@pytest.mark.parametrize("linear", [True, False], ids=["linear_proj", "conv_proj"])
def test_transformer2d_parity(linear):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, 16, 16).astype(np.float32)  # 256 tokens: self-attn takes flash
    ctx = rs.randn(2, 5, 12).astype(np.float32)
    jm = jattn_mod.Transformer2DModel(num_heads=2, head_dim=8, num_layers=2,
                                      use_linear_projection=linear, groups=4)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ctx))
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tm = _port(Transformer2DModel(16, 2, 8, cross_dim=12, num_layers=2,
                                  use_linear_projection=linear, groups=4),
               params["params"], UNET_KEY_MAP)
    out = tm(_nchw(x), torch.from_numpy(ctx))
    _assert_close(ref, _nhwc(out), tol=1e-5)


def test_unet_sdxl_parity(jax_models):
    rs = np.random.RandomState(2)
    sample = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 6, 32).astype(np.float32)
    text_embeds = rs.randn(2, 16).astype(np.float32)
    time_ids = np.tile(np.asarray([[32, 32, 0, 0, 32, 32]], np.float32), (2, 1))
    t = np.asarray([700.0, 700.0], np.float32)
    ju = jax_models["unet"]
    ref = ju(jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
             added_cond_kwargs={"text_embeds": jnp.asarray(text_embeds),
                                "time_ids": jnp.asarray(time_ids)})
    tu = _port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL)), ju.params,
               UNET_KEY_MAP)
    with torch.no_grad():
        out = tu(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx),
                 added_cond_kwargs={"text_embeds": torch.from_numpy(text_embeds),
                                    "time_ids": torch.from_numpy(time_ids)})
    _assert_close(ref, out, tol=1e-4)


def test_vae_decode_parity(jax_models):
    z = np.random.RandomState(3).randn(1, 4, 4, 4).astype(np.float32)
    jv = jax_models["vae"]
    ref = jv.decode(jnp.asarray(z))
    tv = _port(AutoencoderKL(AutoencoderKLConfig(**TINY_VAE)), _vae_decode_params(jv),
               VAE_KEY_MAP)
    with torch.no_grad():
        out = tv.decode(torch.from_numpy(z))
    _assert_close(ref, out, tol=1e-4)


@pytest.mark.parametrize("name", ["te1", "te2"])
def test_clip_text_parity(jax_models, name):
    tok, jm = jax_models["tok"], jax_models[name]
    ids = tok(["a cat on a mat", ""])["input_ids"]
    ref_last, ref_pooled, ref_hidden = jm(jnp.asarray(ids), output_hidden_states=True)
    cls = CLIPTextModel if name == "te1" else CLIPTextModelWithProjection
    tm = _port(cls(_text_config(tok)), jm.params, CLIP_KEY_MAP)
    with torch.no_grad():
        last, pooled, hidden = tm(torch.from_numpy(ids).long(), output_hidden_states=True)
    assert len(hidden) == len(ref_hidden) == 3
    _assert_close(ref_last, last, tol=1e-5)
    _assert_close(ref_pooled, pooled, tol=1e-5)
    for r, h in zip(ref_hidden, hidden):
        _assert_close(r, h, tol=1e-5)


# --------------------------------------------------------------- scheduler
def test_euler_sequence_matches_jax():
    kw = dict(num_train_timesteps=1000, beta_schedule="scaled_linear", beta_start=0.00085,
              beta_end=0.012, timestep_spacing="leading")
    js, ts = JEuler(**kw), EulerDiscreteScheduler(**kw)
    jstate, tstate = js.set_timesteps(5), ts.set_timesteps(5)
    np.testing.assert_allclose(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    # fp32 linspace/cumprod round differently in the two frameworks
    np.testing.assert_allclose(tstate.sigmas.numpy(), np.asarray(jstate.sigmas), rtol=1e-5)
    assert ts.init_noise_sigma == pytest.approx(js.init_noise_sigma, rel=1e-5)
    rs = np.random.RandomState(4)
    sample = rs.randn(1, 4, 4, 4).astype(np.float32) * ts.init_noise_sigma
    jx, tx = jnp.asarray(sample), torch.from_numpy(sample)
    for i in range(5):
        eps = rs.randn(*sample.shape).astype(np.float32)
        _assert_close(js.scale_model_input(jstate, jx, i), ts.scale_model_input(tstate, tx, i),
                      tol=1e-5)
        jx, jstate = js.step(jstate, jnp.asarray(eps), i, jx)
        tx, tstate = ts.step(tstate, torch.from_numpy(eps), i, tx)
    _assert_close(jx, tx, tol=1e-5)


# -------------------------------------------------------- bf16 gelu rule
def test_gelu_dtype_rule():
    x = torch.linspace(-4, 4, 257)
    assert torch.equal(tact.gelu_exact(x), torch.nn.functional.gelu(x))
    xb = x.bfloat16()
    assert torch.equal(tact.gelu_exact(xb), torch.nn.functional.gelu(xb, approximate="tanh"))
    # JAX takes the tanh form below fp32 too; the two agree to a bf16 ulp
    ref = jact.gelu_exact(jnp.asarray(x.numpy(), jnp.bfloat16))
    _assert_close(np.asarray(ref, np.float32), tact.gelu_exact(xb).float(), tol=1e-2)


def test_geglu_feedforward_bf16():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 7, 16).astype(np.float32)
    jm = jattn_mod.GEGLUFeedForward(dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x, jnp.bfloat16))
    ref = jm.apply(params, jnp.asarray(x, jnp.bfloat16))
    tm = _port(GEGLUFeedForward(16), params["params"], UNET_KEY_MAP).bfloat16()
    with torch.no_grad():
        out = tm(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    # bf16 products round at other places in the two frameworks: a few bf16 ulps
    _assert_close(np.asarray(ref, np.float32), out.float(), tol=3e-2)
