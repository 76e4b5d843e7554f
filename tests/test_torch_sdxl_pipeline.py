"""The tiny SDXL pipeline end to end: the JAX package and the port on the same
tokenizer, weights (carried over with `flax_to_torch_state_dict`) and numpy
latents, 2 Euler steps at 32 px, fp32 on the CPU."""

import numpy as np
import pytest
import torch

from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import EulerDiscreteScheduler as JEuler
from paddlemix_tpu.diffusers import StableDiffusionXLPipeline as JPipeline
from paddlemix_tpu_torch.core import (
    CLIP_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    flax_to_torch_state_dict,
)
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    EulerDiscreteScheduler,
    StableDiffusionXLPipeline,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    CLIPTokenizer,
)
from paddlemix_tpu_torch.diffusers.sdxl import byte_level_tokenizer
from paddlemix_tpu_torch.ops import flash_attention, group_norm
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae
from test_torch_sdxl_modules import TINY_UNET_SDXL, TINY_VAE

pytestmark = pytest.mark.torch_port

CALL = dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=2, guidance_scale=5.0)


def _port(module, flax_params, key_map):
    module.load_state_dict(flax_to_torch_state_dict(flatten_params(flax_params), module,
                                                    key_map))
    return module.eval()


@pytest.fixture(scope="module")
def pipes():
    jtok = tiny_tokenizer()
    jpipe = JPipeline(vae=tiny_vae(), text_encoder=tiny_text_encoder(jtok, dim=16),
                      text_encoder_2=tiny_text_encoder(jtok, with_projection=True, dim=16),
                      tokenizer=jtok, tokenizer_2=jtok, unet=tiny_unet(ctx_dim=32, sdxl=True),
                      scheduler=JEuler())
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    text_cfg = CLIPTextConfig(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=16, eos_token_id=tok.eos_token_id,
                              projection_dim=16)
    vae_params = {k: v for k, v in jpipe.vae.params.items() if k != "encoder"
                  and k != "quant_conv"}
    pipe = StableDiffusionXLPipeline(
        vae=_port(AutoencoderKL(AutoencoderKLConfig(**TINY_VAE)), vae_params, VAE_KEY_MAP),
        text_encoder=_port(CLIPTextModel(text_cfg), jpipe.text_encoder.params, CLIP_KEY_MAP),
        text_encoder_2=_port(CLIPTextModelWithProjection(text_cfg),
                             jpipe.text_encoder_2.params, CLIP_KEY_MAP),
        tokenizer=tok, tokenizer_2=tok,
        unet=_port(UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SDXL)),
                   jpipe.unet.params, UNET_KEY_MAP),
        scheduler=EulerDiscreteScheduler())
    f = pipe.vae_scale_factor  # 2 for the tiny two-level VAE
    latents = np.random.RandomState(0).randn(1, 32 // f, 32 // f, 4).astype(np.float32)
    return jpipe, pipe, latents


def test_tokenizer_copy_matches(pipes):
    jpipe, pipe, _ = pipes
    texts = ["a cat", "A Photo of 2 dogs!", ""]
    np.testing.assert_array_equal(pipe.tokenizer(texts)["input_ids"],
                                  jpipe.tokenizer(texts)["input_ids"])


def test_sdxl_latents_match_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = np.asarray(jpipe(**CALL, latents=latents, output_type="latent")[0])
    out = pipe(**CALL, latents=latents, output_type="latent")[0]
    assert out.dtype == torch.float32 and tuple(out.shape) == latents.shape
    # fp32 on both sides; 2 steps amplify summation-order differences a little
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_sdxl_image_matches_jax(pipes):
    jpipe, pipe, latents = pipes
    ref = jpipe(**CALL, latents=latents, output_type="np")[0]
    out = pipe(**CALL, latents=torch.from_numpy(latents), output_type="np")[0]
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert flash_attention.launches == 0 and group_norm.launches == 0  # CPU: plain versions


def _counting(monkeypatch):
    """Count flash, GroupNorm and LayerNorm calls on the CPU, where the
    kernels' counters stay 0."""
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod
    from paddlemix_tpu_torch.models import layers as layers_mod
    from paddlemix_tpu_torch.ops import attention as attn_mod

    counts = {"flash_attention": 0, "group_norm": 0, "layer_norm": 0}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(attn_mod, "flash_attention", wrap("flash_attention",
                                                          attn_mod.flash_attention))
    monkeypatch.setattr(resnet_mod, "group_norm", wrap("group_norm", resnet_mod.group_norm))
    monkeypatch.setattr(layers_mod, "layer_norm", wrap("layer_norm", layers_mod.layer_norm))
    return counts


def test_random_pipeline_launches_match_walk(monkeypatch):
    from paddlemix_tpu_torch.diffusers.sdxl import expected_launches, random_sdxl_pipeline

    tok = byte_level_tokenizer(model_max_length=16)
    text = dict(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2, projection_dim=16)
    pipe = random_sdxl_pipeline("cpu", torch.float32, seed=0, unet=TINY_UNET_SDXL, vae=TINY_VAE,
                                text_encoder=dict(text, hidden_act="quick_gelu"),
                                text_encoder_2=dict(text, hidden_act="gelu"), tokenizer=tok)
    counts = _counting(monkeypatch)
    image = pipe("a cat", height=32, width=32, num_inference_steps=2, guidance_scale=5.0,
                 seed=1, output_type="np")[0]
    assert image.shape == (1, 32, 32, 3) and np.isfinite(image).all()
    expected = expected_launches(pipe, 32, 32, 2, guidance_scale=5.0)
    # 256-token self-attention at the top level (3 blocks x 2 steps) and the VAE's
    # 256-token 16-wide head take flash; everything else is math; each 2-layer
    # text tower's 5 LayerNorms run for the prompt and the negative prompt
    assert expected == {"flash_attention": 3 * 2 + 1, "group_norm": counts["group_norm"],
                        "layer_norm": 2 * (5 + 5)}
    assert counts == expected


def test_expected_launches_full_width_sdxl():
    from paddlemix_tpu_torch.diffusers.sdxl import (
        SDXL_SCHEDULER,
        SDXL_TEXT_ENCODER,
        SDXL_TEXT_ENCODER_2,
        SDXL_UNET,
        SDXL_VAE,
        expected_launches,
    )

    tok = byte_level_tokenizer()
    with torch.device("meta"):  # shapes only: nothing of the model's size is allocated
        pipe = StableDiffusionXLPipeline(
            vae=AutoencoderKL(AutoencoderKLConfig(**SDXL_VAE)),
            text_encoder=CLIPTextModel(CLIPTextConfig(**SDXL_TEXT_ENCODER,
                                                      eos_token_id=tok.eos_token_id)),
            text_encoder_2=CLIPTextModelWithProjection(
                CLIPTextConfig(**SDXL_TEXT_ENCODER_2, eos_token_id=tok.eos_token_id)),
            tokenizer=tok, tokenizer_2=tok,
            unet=UNet2DConditionModel(UNet2DConditionConfig(**SDXL_UNET)),
            scheduler=EulerDiscreteScheduler(**SDXL_SCHEDULER))
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    assert 2.56e9 < n_unet < 2.57e9  # SDXL base UNet: 2.567 B parameters
    # 70 self-attentions per UNet forward take flash; 46 GroupNorms per UNet
    # forward and 30 in the VAE decoder; the CLIP-L and bigG towers' 2 x 12 + 1
    # and 2 x 32 + 1 LayerNorms for the prompt and the negative prompt
    assert expected_launches(pipe, 1024, 1024, 25) == {"flash_attention": 70 * 25,
                                                       "group_norm": 46 * 25 + 30,
                                                       "layer_norm": 2 * (25 + 65)}
