"""SDXL base 1.0 at its published widths, with seeded random weights.

The widths are those of the public stabilityai/stable-diffusion-xl-base-1.0
configs (unet, vae, text_encoder = CLIP ViT-L/14 text, text_encoder_2 =
OpenCLIP ViT-bigG/14 text with projection); `SDXL_UNET` is the JAX package's
`__graft_entry__.SDXL_UNET`. No checkpoint is read: weights come from a
torch.Generator (core.init), made on the target device.

The static-a8w8 configuration (`quant="a8w8_static"`, the JAX bench's default
recipe) builds the UNet and the VAE decoder with static a8w8 ops; until
`calibrate_static_a8w8` has loaded their scales the same pipeline serves
bf16.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import torch

from ..core.init import build_random
from ..models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    CLIPTokenizer,
)
from ..models.clip.tokenizer import byte_level_tokenizer
from ..models.layers import n_layer_norms
from ..ops.attention import int8_qk_default, use_flash
from ..ops.quant import (
    QuantConv2d,
    QuantLinear,
    load_static_scales,
    quant_modules,
    static_a8w8_scope,
)
from .models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from .models.resnet import ResnetBlock2D, group_norm_calls, n_group_norms
from .pipelines import StableDiffusionXLPipeline
from .pipelines.pipeline_utils import make_scheduler_state
from .schedulers import EulerDiscreteScheduler

SDXL_UNET = dict(
    sample_size=128,
    in_channels=4,
    out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280),
    layers_per_block=2,
    cross_attention_dim=2048,
    num_attention_heads=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)
SDXL_VAE = dict(scaling_factor=0.13025)  # AutoencoderKLConfig defaults: (128, 256, 512, 512)
SDXL_TEXT_ENCODER = dict(  # CLIP ViT-L/14 text
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, hidden_act="quick_gelu", projection_dim=768)
SDXL_TEXT_ENCODER_2 = dict(  # OpenCLIP ViT-bigG/14 text + projection
    vocab_size=49408, hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
    num_attention_heads=20, hidden_act="gelu", projection_dim=1280)
SDXL_SCHEDULER = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                      beta_start=0.00085, beta_end=0.012, timestep_spacing="leading")


def random_sdxl_pipeline(device, dtype=torch.bfloat16, seed: int = 0,
                         unet: Dict = SDXL_UNET, vae: Dict = SDXL_VAE,
                         text_encoder: Dict = SDXL_TEXT_ENCODER,
                         text_encoder_2: Dict = SDXL_TEXT_ENCODER_2,
                         tokenizer: Optional[CLIPTokenizer] = None,
                         quant: Optional[str] = None) -> StableDiffusionXLPipeline:
    """An SDXL pipeline with weights drawn on `device` from one seeded generator.
    Feature-map weights are put in channels_last memory. `quant="a8w8_static"`
    builds the UNet and the VAE decoder with static a8w8 ops."""
    tok = tokenizer or byte_level_tokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    te1_cfg = CLIPTextConfig(**text_encoder, eos_token_id=tok.eos_token_id,
                             max_position_embeddings=tok.model_max_length)
    te2_cfg = CLIPTextConfig(**text_encoder_2, eos_token_id=tok.eos_token_id,
                             max_position_embeddings=tok.model_max_length)
    return StableDiffusionXLPipeline(
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**vae, quant=quant)), **kw)
        .to(memory_format=torch.channels_last),
        text_encoder=build_random(lambda: CLIPTextModel(te1_cfg), **kw),
        text_encoder_2=build_random(lambda: CLIPTextModelWithProjection(te2_cfg), **kw),
        tokenizer=tok, tokenizer_2=tok,
        unet=build_random(lambda: UNet2DConditionModel(UNet2DConditionConfig(**unet, quant=quant)),
                          **kw)
        .to(memory_format=torch.channels_last),
        scheduler=EulerDiscreteScheduler(**SDXL_SCHEDULER))


@torch.inference_mode()
def record_static_a8w8(pipe: StableDiffusionXLPipeline, prompt, height: int = 1024,
                       width: int = 1024, num_inference_steps: int = 25,
                       guidance_scale: float = 5.0, negative_prompt=None, seed: int = 0,
                       latents=None) -> static_a8w8_scope:
    """The calibration pass of a quantized pipeline (port of the JAX bench's
    calibration, bench.py): one UNet forward at timesteps[0] on the
    CFG-doubled initial noise (before init_noise_sigma), conditioned on the
    encoded `prompt`, then one VAE decode of the initial noise /
    scaling_factor, inside a record scope. Returns the scope: its `modules`
    and raw absmax values, UNet ops first and VAE ops after them, in the JAX
    package's call order, ready for `load_static_scales` (with these values
    or, e.g., a list the JAX package recorded). The forwards run the plain
    path whether or not scales are loaded already (see ops/quant.py)."""
    context, added, latents = pipe.prepare_inputs(prompt, height, width, guidance_scale,
                                                  negative_prompt, seed, latents)
    state = make_scheduler_state(pipe.scheduler, num_inference_steps,
                                 sample_shape=tuple(latents.shape))
    lat_in = torch.cat([latents, latents]) if guidance_scale > 1.0 else latents
    t_in = state.timesteps[0].to(latents.device).expand(lat_in.shape[0])
    with static_a8w8_scope() as rec:
        pipe.unet(lat_in.to(pipe.unet.dtype), t_in, context, added_cond_kwargs=added)
        n_unet = len(rec.modules)
        pipe.vae.decode(latents / pipe.vae.config.scaling_factor)
    if not rec.modules:
        raise ValueError("record_static_a8w8: the pipeline has no quantized ops "
                         "(build it with quant='a8w8_static')")
    if n_unet != len(quant_modules(pipe.unet)) or \
            len(rec.modules) - n_unet != len(quant_modules(pipe.vae)):
        raise RuntimeError("record_static_a8w8: the forward did not call every quantized op "
                           "exactly once")
    return rec


def calibrate_static_a8w8(pipe: StableDiffusionXLPipeline, *args, **kwargs) -> List[float]:
    """`record_static_a8w8` (same arguments), then load the recorded scales.
    Returns the raw absmax list in call order."""
    rec = record_static_a8w8(pipe, *args, **kwargs)
    raw = rec.raw()
    load_static_scales(rec.modules, raw)
    return raw


def transformer_levels(unet: UNet2DConditionModel):
    """(down level, Transformer2DModel) for every spatial transformer."""
    n = len(unet.config.block_out_channels)
    for i, blk in enumerate(unet.down_blocks):
        for t in getattr(blk, "attentions", []):
            yield i, t
    for t in unet.mid_block.attentions:
        yield n - 1, t
    for i, blk in enumerate(unet.up_blocks):
        for t in getattr(blk, "attentions", []):
            yield n - 1 - i, t


def _text_encoders(pipe):
    return [enc for enc in (pipe.text_encoder, getattr(pipe, "text_encoder_2", None))
            if enc is not None]


def flash_launches_by_dim(pipe, height: int, width: int, num_inference_steps: int,
                          guidance_scale: float) -> Counter:
    """Flash launches of one single-prompt call of a UNet pipeline (SD1.5 or
    SDXL), keyed by the caller's head_dim: every UNet attention call routed
    by `use_flash` at the shape it will see, the VAE's mid-block attention
    and the text towers' (for the prompt and the negative prompt apart)."""
    f = pipe.vae_scale_factor
    rows = 2 if guidance_scale > 1.0 else 1
    text_len = pipe.tokenizer.model_max_length
    out = Counter()
    for level, tf in transformer_levels(pipe.unet):
        tokens = (height // f >> level) * (width // f >> level)
        for blk in tf.transformer_blocks:
            heads, hd = blk.attn1.num_heads, blk.attn1.head_dim
            q = (rows, tokens, heads, hd)
            out[hd] += num_inference_steps * (use_flash(q, q) +
                                              use_flash(q, (rows, text_len, heads, hd)))
    out[pipe.vae.config.block_out_channels[-1]] += pipe.vae.decode_flash_launches(
        height // f, width // f)
    for enc in _text_encoders(pipe):
        cfg = enc.config
        out[cfg.hidden_size // cfg.num_attention_heads] += 2 * enc.text_model.flash_launches(
            text_len)
    return +out  # drop the zero counts


def expected_launches(pipe, height: int, width: int, num_inference_steps: int,
                      guidance_scale: float = 5.0) -> Dict[str, int]:
    """Kernel launches one single-prompt call of a UNet pipeline (SDXL, or
    SD1.5 with its one text tower) should make, from walking the blocks:
    every attention call is routed by `use_flash` at the shape it will see
    (`flash_launches_by_dim`) and counted under `flash_attention`, or under
    `flash_attention_int8` when PMIX_INT8_ATTN=1 sends the inference calls to
    int8 QK^T; every GroupNorm module runs once per forward, and every
    LayerNorm of the text towers (B10) once for the prompt and once for the
    negative prompt. Once scales are loaded, the a8w8 ops are counted by
    `a8w8_routes`, keyed by wrapper name, and the resnets' GroupNorms become
    statistics launches (`group_norm_stats`)."""
    flash = sum(flash_launches_by_dim(pipe, height, width, num_inference_steps,
                                      guidance_scale).values())
    flash_key = "flash_attention_int8" if int8_qk_default() else "flash_attention"
    ln = sum(2 * n_layer_norms(enc) for enc in _text_encoders(pipe))

    if not any(m.sx is not None for m in quant_modules(pipe.unet) + quant_modules(pipe.vae)):
        gn = n_group_norms(pipe.unet) * num_inference_steps + n_group_norms(pipe.vae.decoder)
        return {flash_key: flash, "group_norm": gn, "layer_norm": ln}
    out = Counter({flash_key: flash, "layer_norm": ln})
    for model, calls in ((pipe.unet, num_inference_steps), (pipe.vae.decoder, 1)):
        routes = a8w8_routes(model)
        routes["group_norm"] = n_group_norms(model) - routes["group_norm_stats"]
        for name, n in routes.items():
            out[name] += n * calls
    return dict(out)


_WALK_HW = 8  # latents of the walks: every attention short enough for math (64 keys)


def _scaled(calls: Counter, factor: int) -> Counter:
    """Walked calls at `factor` times the walk's spatial size (the models are
    fully convolutional and halve or double H and W exactly)."""
    out = Counter()
    for (name, (b, h, w, c), act), n in calls.items():
        out[name, (b, h * factor, w * factor, c), act] += n
    return out


def unet_group_norm_calls(unet: Dict, batch: int, latent_hw: int, fused: bool = False,
                          text_len: int = 77) -> Counter:
    """The GroupNorm calls (`resnet.group_norm_calls`) of one forward of the
    UNet of config `unet` over `batch` latents of latent_hw x latent_hw (a
    multiple of 8), walked on the meta device at 8 x 8 and scaled;
    `fused`: as the static a8w8 path runs them."""
    with torch.device("meta"):
        model = UNet2DConditionModel(UNet2DConditionConfig(**unet))
        cfg = model.config
        lat = torch.empty((batch, _WALK_HW, _WALK_HW, cfg.in_channels))
        ctx = torch.empty((batch, text_len, cfg.cross_attention_dim))
        added = None
        if cfg.addition_embed_type == "text_time":
            added = {"time_ids": torch.empty((batch, 6)), "text_embeds": torch.empty(
                (batch, cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim))}
        with torch.no_grad():
            calls = group_norm_calls(model, lambda: model(lat, torch.empty(batch), ctx,
                                                          added_cond_kwargs=added), fused)
    return _scaled(calls, latent_hw // _WALK_HW)


def vae_group_norm_calls(vae: Dict, latent_hw: int, fused: bool = False) -> Counter:
    """The GroupNorm calls of one batch-1 decode by the VAE of config `vae` of
    latent_hw x latent_hw latents (a multiple of 8), walked as the UNet's."""
    with torch.device("meta"):
        model = AutoencoderKL(AutoencoderKLConfig(**vae))
        z = torch.empty((1, _WALK_HW, _WALK_HW, model.config.latent_channels))
        with torch.no_grad():
            calls = group_norm_calls(model.decoder, lambda: model.decode(z), fused)
    return _scaled(calls, latent_hw // _WALK_HW)


def a8w8_routes(model) -> Counter:
    """Launches of each a8w8 op (by wrapper name) in one forward of a model
    with its scales loaded: every resnet's two 3x3 convs are one fused
    GroupNorm+SiLU+int8-conv call each (whose affine is one GroupNorm
    statistics launch), every Linear and 1x1 conv the int8 GEMM, every other
    conv as `conv_route` says."""
    routes, fused = Counter(), set()
    for m in model.modules():
        if isinstance(m, ResnetBlock2D) and isinstance(m.conv1, QuantConv2d):
            fused |= {m.conv1, m.conv2}
            routes["fused_gn_silu_conv3x3"] += 2
            routes["group_norm_stats"] += 2
    for m in quant_modules(model):
        if m not in fused:
            routes["int8_a8w8_matmul" if isinstance(m, QuantLinear) else m.route] += 1
    return routes
