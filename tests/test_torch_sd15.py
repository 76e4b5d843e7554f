"""The SD1.5 slice of the port against the JAX package: PNDM over 50 steps,
an SD1.5-layout UNet (1x1-conv projections, a DownBlock2D last and an
UpBlock2D first, head counts from `attention_head_dim`) on shared weights,
and the pipeline end to end with given latents; the launch walk at full
width. Weights come from the JAX modules' seeded init and are carried over
with `load_flax_sd15_pipeline` / `flax_to_torch_state_dict`; inputs are made
with numpy. Everything runs in fp32 on the CPU, so the tolerances cover
summation order only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers.schedulers import PNDMScheduler as JPNDM
from paddlemix_tpu.diffusers import StableDiffusionPipeline as JPipeline
from paddlemix_tpu.diffusers import UNet2DConditionConfig as JUNetConfig
from paddlemix_tpu.diffusers import UNet2DConditionModel as JUNet
from paddlemix_tpu.diffusers.single_file import SD15_UNET_CONFIG, SD15_VAE_CONFIG
from paddlemix_tpu_torch.core import UNET_KEY_MAP, flax_to_torch_state_dict, torch_key_to_flax
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    PNDMScheduler,
    StableDiffusionPipeline,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers.sd15 import (
    SD15_SCHEDULER,
    SD15_TEXT_ENCODER,
    SD15_UNET,
    SD15_VAE,
    expected_launches_sd15,
    load_flax_sd15_pipeline,
    random_sd15_pipeline,
)
from paddlemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, CLIPTokenizer
from paddlemix_tpu_torch.models.clip.tokenizer import byte_level_tokenizer
from paddlemix_tpu_torch.ops import flash_attention, group_norm
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae
from test_torch_sdxl_modules import TINY_VAE

pytestmark = pytest.mark.torch_port

# test_pipelines.tiny_unet(ctx_dim=32): the SD1.5 block layout at two levels
TINY_UNET_SD15 = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8,
)
# a wider top level: 2 heads of 160 over 320 channels, whose 256-token
# self-attention both packages send to flash (head_dim 129-256)
WIDE_UNET_SD15 = dict(
    sample_size=16, block_out_channels=(320, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=24, attention_head_dim=2, norm_num_groups=8,
)
CALL = dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=5, guidance_scale=7.5)


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _text_config(tok, dim=32):
    return CLIPTextConfig(vocab_size=tok.vocab_size, hidden_size=dim, intermediate_size=dim * 2,
                          num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
                          eos_token_id=tok.eos_token_id, projection_dim=dim)


# ------------------------------------------------------------------ configs
def test_configs_are_the_jax_packages():
    assert SD15_UNET == SD15_UNET_CONFIG
    assert SD15_VAE == SD15_VAE_CONFIG
    from paddlemix_tpu.models.clip.configuration import CLIPTextConfig as JText

    # the JAX single-file loader's CLIP-L (single_file.py): 768 wide, 3,072 MLP,
    # 12 layers of 12 heads, 77 positions, the config's default activation
    j = JText(vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
              num_attention_heads=12, max_position_embeddings=77)
    assert j.hidden_act == "quick_gelu"
    assert all(SD15_TEXT_ENCODER[k] == getattr(j, k) for k in SD15_TEXT_ENCODER)
    js = JPNDM(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
               skip_prk_steps=True)  # single_file.py's scheduler
    ts = PNDMScheduler(**SD15_SCHEDULER)
    assert all(getattr(ts.config, k) == getattr(js.config, k)
               for k in ("num_train_timesteps", "beta_schedule", "beta_start", "beta_end",
                         "timestep_spacing", "steps_offset", "set_alpha_to_one"))


# --------------------------------------------------------------- scheduler
@pytest.mark.parametrize("steps_offset,alpha_to_one", [(0, False), (1, True)])
def test_pndm_matches_jax_over_50_steps(steps_offset, alpha_to_one):
    kw = dict(SD15_SCHEDULER, steps_offset=steps_offset, set_alpha_to_one=alpha_to_one)
    js, ts = JPNDM(**kw), PNDMScheduler(**kw)
    shape = (1, 4, 4, 4)
    jstate, tstate = js.set_timesteps(50, sample_shape=shape), ts.set_timesteps(50)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(tstate.prev_timesteps.numpy(),
                                  np.asarray(jstate.prev_timesteps))
    assert tstate.timesteps[0] == 980 + steps_offset and tstate.prev_timesteps[-1] < 0
    rs = np.random.RandomState(5)
    sample = rs.randn(*shape).astype(np.float32)
    jx, tx = jnp.asarray(sample), torch.from_numpy(sample)
    for i in range(50):
        eps = rs.randn(*shape).astype(np.float32)
        jx, jstate = js.step(jstate, jnp.asarray(eps), i, jx)
        tx, tstate = ts.step(tstate, torch.from_numpy(eps), i, tx)
        # fp32 linspace / cumprod round differently in the two frameworks
        _assert_close(jx, tx, tol=2e-5)
    assert len(tstate.ets) == 4


# ----------------------------------------------------------------- the UNet
@pytest.fixture(scope="module")
def jax_unet():
    return tiny_unet(ctx_dim=32)


def test_unet_conversion_consumes_every_jax_key_once(jax_unet):
    module = UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SD15))
    flat = flatten_params(jax_unet.params)
    sd = flax_to_torch_state_dict(flat, module, UNET_KEY_MAP)  # raises on any leftover key
    assert sorted(torch_key_to_flax(k, UNET_KEY_MAP) for k in module.state_dict()) == \
        sorted(flat)
    # the 1x1-conv projections: HWIO (1, 1, in, out) -> OIHW (out, in, 1, 1)
    key = "down_blocks.0.attentions.0.proj_in.weight"
    assert sd[key].shape == (16, 16, 1, 1)
    np.testing.assert_array_equal(sd[key].numpy()[:, :, 0, 0],
                                  np.asarray(flat["down_blocks_0.attentions_0.proj_in.kernel"]
                                             )[0, 0].T)


def _unet_parity(ju, config, sample, ctx, t):
    ref = ju(jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    tu = UNet2DConditionModel(UNet2DConditionConfig(**config))
    tu.load_state_dict(flax_to_torch_state_dict(flatten_params(ju.params), tu, UNET_KEY_MAP))
    with torch.no_grad():
        out = tu.eval()(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    return ref, out, tu


def test_unet_sd15_layout_parity(jax_unet):
    rs = np.random.RandomState(2)
    ref, out, tu = _unet_parity(jax_unet, TINY_UNET_SD15, rs.randn(2, 8, 8, 4).astype(np.float32),
                                rs.randn(2, 6, 32).astype(np.float32),
                                np.asarray([981.0, 981.0], np.float32))
    assert tu.down_blocks[0].attentions[0].proj_in.weight.ndim == 4  # conv projection
    assert [b.attentions[0].transformer_blocks[0].attn1.num_heads
            for b in (tu.down_blocks[0], tu.up_blocks[1])] == [2, 2]
    _assert_close(ref, out, tol=1e-4)


def test_unet_wide_head_parity(monkeypatch):
    """The JAX UNet runs its 256-token, head_dim-160 self-attention through
    the Pallas flash kernel (interpret mode, padded to 256 lanes); the port's
    routing sends it to flash too (the plain version on the CPU)."""
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    from paddlemix_tpu.ops import attention as jattn

    taken = []
    real = jattn.flash_attention
    monkeypatch.setattr(jattn, "flash_attention",
                        lambda q, *a, **kw: taken.append(q.shape) or real(q, *a, **kw))
    ju = JUNet.from_config(JUNetConfig.from_dict(WIDE_UNET_SD15))
    rs = np.random.RandomState(3)
    ref, out, tu = _unet_parity(ju, WIDE_UNET_SD15, rs.randn(1, 16, 16, 4).astype(np.float32),
                                rs.randn(1, 5, 24).astype(np.float32),
                                np.asarray([500.0], np.float32))
    assert (1, 256, 2, 160) in taken
    assert tu.down_blocks[0].attentions[0].transformer_blocks[0].attn1.head_dim == 160
    _assert_close(ref, out, tol=1e-4)


# ------------------------------------------------------------ the pipeline
@pytest.fixture(scope="module")
def pipes():
    jtok = tiny_tokenizer()
    jpipe = JPipeline(vae=tiny_vae(), text_encoder=tiny_text_encoder(jtok), tokenizer=jtok,
                      unet=tiny_unet(ctx_dim=32), scheduler=JPNDM(**SD15_SCHEDULER))
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    pipe = StableDiffusionPipeline(
        vae=AutoencoderKL(AutoencoderKLConfig(**TINY_VAE)),
        text_encoder=CLIPTextModel(_text_config(tok)), tokenizer=tok,
        unet=UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SD15)),
        scheduler=PNDMScheduler(**SD15_SCHEDULER))
    load_flax_sd15_pipeline(pipe, {"unet": jpipe.unet.params, "vae": jpipe.vae.params,
                                   "text_encoder": jpipe.text_encoder.params})
    f = pipe.vae_scale_factor  # 2 for the tiny two-level VAE
    latents = np.random.RandomState(0).randn(1, 32 // f, 32 // f, 4).astype(np.float32)
    return jpipe, pipe, latents


@pytest.mark.parametrize("clip_skip", [None, 1])
def test_encode_prompt_matches_jax(pipes, clip_skip):
    jpipe, pipe, _ = pipes
    ref = jpipe.encode_prompt("a cat", "blurry", clip_skip=clip_skip)
    with torch.no_grad():
        out = pipe.encode_prompt("a cat", "blurry", clip_skip=clip_skip)
    for r, o in zip(ref, out):
        _assert_close(r, o, tol=1e-5)


def test_sd15_latents_match_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = np.asarray(jpipe(**CALL, latents=latents, output_type="latent")[0])
    out = pipe(**CALL, latents=latents, output_type="latent")[0]
    assert out.dtype == torch.float32 and tuple(out.shape) == latents.shape
    # fp32 on both sides; 5 PNDM steps (orders 1-4) amplify summation-order
    # differences a little
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_sd15_image_matches_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = jpipe(**CALL, latents=latents, output_type="np")[0]
    out = pipe(**CALL, latents=torch.from_numpy(latents), output_type="np")[0]
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert flash_attention.launches == 0 and group_norm.launches == 0  # CPU: plain versions


def test_unported_entry_points_raise(pipes):
    _, pipe, _ = pipes
    with pytest.raises(NotImplementedError):
        StableDiffusionPipeline.from_single_file("model.safetensors")
    with pytest.raises(NotImplementedError):
        pipe.load_ip_adapter("ip_adapter.bin")
    with pytest.raises(NotImplementedError):  # the PRK warm-up, which JAX has not either
        PNDMScheduler(**dict(SD15_SCHEDULER, skip_prk_steps=False))
    with pytest.raises(NotImplementedError):
        pipe("a cat", height=32, width=32, num_inference_steps=1,
             ip_adapter_image_embeds=np.zeros((1, 8), np.float32))


# ----------------------------------------------------------------- launches
def test_random_pipeline_launches_match_walk(monkeypatch):
    from test_torch_sdxl_pipeline import _counting

    tok = byte_level_tokenizer(model_max_length=16)
    pipe = random_sd15_pipeline("cpu", torch.float32, seed=0, unet=TINY_UNET_SD15,
                                vae=TINY_VAE, tokenizer=tok,
                                text_encoder=dict(vocab_size=tok.vocab_size, hidden_size=32,
                                                  intermediate_size=64, num_hidden_layers=2,
                                                  num_attention_heads=2))
    counts = _counting(monkeypatch)
    image = pipe("a cat", height=32, width=32, num_inference_steps=3, seed=1,
                 output_type="np")[0]
    assert image.shape == (1, 32, 32, 3) and np.isfinite(image).all()
    expected = expected_launches_sd15(pipe, 32, 32, 3)
    # the top level's 256-token self-attention (head_dim 8; 1 down and 2 up
    # blocks x 3 steps) and the VAE's 256-token 16-wide head take flash; the
    # tower's 5 LayerNorms run for the prompt and the negative prompt
    assert expected.pop("flash_attention_by_dim") == {8: 3 * 3, 16: 1}
    assert expected == {"flash_attention": 3 * 3 + 1, "group_norm": counts["group_norm"],
                        "layer_norm": 2 * 5}
    assert counts == expected


def test_expected_launches_full_width_sd15():
    tok = byte_level_tokenizer()
    with torch.device("meta"):  # shapes only: nothing of the model's size is allocated
        pipe = StableDiffusionPipeline(
            vae=AutoencoderKL(AutoencoderKLConfig(**SD15_VAE)),
            text_encoder=CLIPTextModel(CLIPTextConfig(**SD15_TEXT_ENCODER,
                                                      eos_token_id=tok.eos_token_id)),
            tokenizer=tok, unet=UNet2DConditionModel(UNet2DConditionConfig(**SD15_UNET)),
            scheduler=PNDMScheduler(**SD15_SCHEDULER))
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    assert 8.59e8 < n_unet < 8.60e8  # SD1.5 UNet: 859.52 M parameters
    heads = [(t.transformer_blocks[0].attn1.num_heads, t.transformer_blocks[0].attn1.head_dim)
             for b in pipe.unet.down_blocks for t in getattr(b, "attentions", [])]
    assert heads == [(8, 40)] * 2 + [(8, 80)] * 2 + [(8, 160)] * 2
    # 15 self-attentions a forward take flash, 5 at each head_dim; the mid
    # block's 64 tokens, the 77-token cross-attention, the causal text tower and
    # the VAE's 512-wide head go to math. 61 GroupNorms a UNet forward, 30 in
    # the VAE decoder; the CLIP-L tower's 2 x 12 + 1 LayerNorms for the prompt
    # and the negative prompt
    assert expected_launches_sd15(pipe) == {
        "flash_attention": 15 * 50, "flash_attention_by_dim": {40: 250, 80: 250, 160: 250},
        "group_norm": 61 * 50 + 30, "layer_norm": 2 * 25}
