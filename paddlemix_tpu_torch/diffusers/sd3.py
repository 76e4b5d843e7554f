"""SD3-medium at its published widths, with seeded random weights.

The widths are those of the public stabilityai/stable-diffusion-3-medium-diffusers
configs: transformer (MM-DiT, 24 blocks of 24 heads x 64, patch 2, 16 latent
channels, joint_attention_dim 4096, pooled_projection_dim 2048), text_encoder
= CLIP ViT-L/14 text with projection 768, text_encoder_2 = OpenCLIP
ViT-bigG/14 text with projection 1280, text_encoder_3 = T5 v1.1-XXL encoder,
vae (128, 256, 512, 512) with 16 latent channels, scheduler FlowMatch Euler
with shift 3.0. They equal the JAX package's defaults. No checkpoint is read:
weights come from a torch.Generator (core.init), made on the target device.
The JAX package has no T5 tokenizer; the pipeline takes any callable, and
`seeded_t5_tokenizer` makes one that needs no vocab file.
`load_flax_sd3_pipeline` carries a JAX SD3 pipeline's parameters over.
"""

from __future__ import annotations

import zlib
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from ..core.convert import (
    CLIP_KEY_MAP,
    SD3_KEY_MAP,
    T5_KEY_MAP,
    VAE_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from ..core.init import build_random
from ..models.clip import CLIPTextConfig, CLIPTextModelWithProjection, CLIPTokenizer
from ..models.clip.tokenizer import byte_level_tokenizer
from ..models.layers import n_layer_norms
from ..models.t5 import T5Config, T5EncoderModel, T5LayerNorm
from ..ops.attention import use_flash
from .models import AutoencoderKL, AutoencoderKLConfig, SD3Transformer2DModel, SD3TransformerConfig
from .models.resnet import n_group_norms
from .pipelines import StableDiffusion3Pipeline
from .pipelines.stable_diffusion_3 import T5_SEQ_LEN
from .schedulers import FlowMatchEulerDiscreteScheduler

SD3_TRANSFORMER = dict(sample_size=128, patch_size=2, in_channels=16, num_layers=24,
                       attention_head_dim=64, num_attention_heads=24, joint_attention_dim=4096,
                       pooled_projection_dim=2048, out_channels=16)
SD3_VAE = dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)
SD3_TEXT_ENCODER = dict(  # CLIP ViT-L/14 text + projection
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, hidden_act="quick_gelu", projection_dim=768)
SD3_TEXT_ENCODER_2 = dict(  # OpenCLIP ViT-bigG/14 text + projection
    vocab_size=49408, hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
    num_attention_heads=20, hidden_act="gelu", projection_dim=1280)
SD3_TEXT_ENCODER_3 = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
                          num_heads=64, layer_norm_epsilon=1e-6)
SD3_SCHEDULER = dict(shift=3.0)


def seeded_t5_tokenizer(seed: int = 0, vocab_size: int = 32128, length: int = T5_SEQ_LEN):
    """A stand-in T5 tokenizer: texts -> {"input_ids": (B, length) int64}. Each
    text gets one id per 4 bytes (at most length - 1), drawn from a generator
    seeded by `seed` and the text, then the eos id 1 and pad id 0, as T5's
    tokenizer lays them out."""
    def tokenize(texts):
        ids = np.zeros((len(texts), length), np.int64)
        for i, text in enumerate(texts):
            n = min(length - 1, len(text.encode()) // 4)
            rs = np.random.RandomState((seed * 1_000_003 + zlib.crc32(text.encode())) % 2 ** 32)
            ids[i, :n] = rs.randint(2, vocab_size, size=n)
            ids[i, n] = 1
        return {"input_ids": ids}
    return tokenize


def random_sd3_pipeline(device, dtype=torch.bfloat16, seed: int = 0,
                        transformer: Dict = SD3_TRANSFORMER, vae: Dict = SD3_VAE,
                        text_encoder: Dict = SD3_TEXT_ENCODER,
                        text_encoder_2: Dict = SD3_TEXT_ENCODER_2,
                        text_encoder_3: Optional[Dict] = SD3_TEXT_ENCODER_3,
                        tokenizer: Optional[CLIPTokenizer] = None,
                        tokenizer_3=None) -> StableDiffusion3Pipeline:
    """An SD3 pipeline with weights drawn on `device` from one seeded
    generator; T5's norm scales stay fp32. `text_encoder_3=None` builds it
    without T5 (its 77 tokens are zeros). The VAE's weights are put in
    channels_last memory."""
    tok = tokenizer or byte_level_tokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    te_cfgs = [CLIPTextConfig(**cfg, eos_token_id=tok.eos_token_id,
                              max_position_embeddings=tok.model_max_length)
               for cfg in (text_encoder, text_encoder_2)]
    t5 = None
    if text_encoder_3 is not None:
        t5_cfg = T5Config(**text_encoder_3)
        t5 = build_random(lambda: T5EncoderModel(t5_cfg), **kw, fp32_modules=(T5LayerNorm,))
        tokenizer_3 = tokenizer_3 or seeded_t5_tokenizer(seed, t5_cfg.vocab_size)
    return StableDiffusion3Pipeline(
        transformer=build_random(lambda: SD3Transformer2DModel(SD3TransformerConfig(**transformer)),
                                 **kw),
        scheduler=FlowMatchEulerDiscreteScheduler(**SD3_SCHEDULER),
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**vae)), **kw)
        .to(memory_format=torch.channels_last),
        text_encoder=build_random(lambda: CLIPTextModelWithProjection(te_cfgs[0]), **kw),
        tokenizer=tok,
        text_encoder_2=build_random(lambda: CLIPTextModelWithProjection(te_cfgs[1]), **kw),
        tokenizer_2=tok, text_encoder_3=t5, tokenizer_3=tokenizer_3 if t5 is not None else None)


def expected_launches_sd3(pipe: StableDiffusion3Pipeline, height: int, width: int,
                          num_inference_steps: int, guidance_scale: float = 7.0
                          ) -> Dict[str, int]:
    """Kernel launches one single-prompt pipeline call should make, keyed by
    wrapper name, from walking the modules. Each transformer block runs two
    adaLN (B12) and, with a context stream after attention, two fused
    adaLN+residual (B13) calls, else one; `norm_out` is one more adaLN. Every
    attention is routed by `use_flash` at the shape it will see: the joint
    attention over image + CLIP + T5 tokens, the causal CLIP towers, T5's
    (which has a bias, so math) and the VAE's. T5's RMSNorms (B11) and the
    CLIP towers' LayerNorms (B10) run once for the prompt and once for the
    negative prompt; the VAE decoder's GroupNorms (B4) once."""
    f = pipe.vae_scale_factor
    rows = 2 if guidance_scale > 1.0 else 1
    tr = pipe.transformer
    p = tr.config.patch_size
    text_len = pipe.tokenizer.model_max_length
    t5_len = T5_SEQ_LEN if pipe.text_encoder_3 is None \
        else len(pipe.tokenizer_3([""])["input_ids"][0])
    tokens = (height // f // p) * (width // f // p) + text_len + t5_len
    per_forward = Counter(adaptive_layer_norm=1)  # norm_out
    for blk in tr.transformer_blocks:
        q = (rows, tokens, blk.num_heads, blk.head_dim)
        per_forward["adaptive_layer_norm"] += 2
        per_forward["fused_adaln_scale_residual"] += 1 if blk.context_pre_only else 2
        per_forward["flash_attention"] += use_flash(q, q)
    out = Counter({name: n * num_inference_steps for name, n in per_forward.items()})
    # the prompt and the negative prompt are encoded apart
    out["flash_attention"] += sum(2 * enc.text_model.flash_launches(text_len)
                                  for enc in (pipe.text_encoder, pipe.text_encoder_2))
    out["layer_norm"] += sum(2 * n_layer_norms(enc)
                             for enc in (pipe.text_encoder, pipe.text_encoder_2))
    out["flash_attention"] += pipe.vae.decode_flash_launches(height // f, width // f)
    out["group_norm"] += n_group_norms(pipe.vae.decoder)
    if pipe.text_encoder_3 is not None:
        out["rms_norm"] += 2 * sum(isinstance(m, T5LayerNorm)
                                   for m in pipe.text_encoder_3.modules())
    return dict(out)


# pipeline component -> key map of the JAX package's model class
_FLAX_KEY_MAPS = {"transformer": SD3_KEY_MAP, "vae": VAE_KEY_MAP, "text_encoder": CLIP_KEY_MAP,
                  "text_encoder_2": CLIP_KEY_MAP, "text_encoder_3": T5_KEY_MAP}


def load_flax_sd3_pipeline(pipe: StableDiffusion3Pipeline, params: Dict[str, dict]
                           ) -> StableDiffusion3Pipeline:
    """Load a JAX SD3 pipeline's parameters into the port's `pipe`: `params`
    maps each component name (`transformer`, `vae`, `text_encoder`,
    `text_encoder_2`, `text_encoder_3`) to its flax params (nested dicts of
    arrays), and every component of `pipe` that is not None must be given.
    The port's VAE is the decoder only, so the JAX VAE's `encoder` and
    `quant_conv` are dropped; every other key on both sides must be consumed
    (see `flax_to_torch_state_dict`). Returns `pipe`."""
    for name, key_map in _FLAX_KEY_MAPS.items():
        module = getattr(pipe, name)
        if module is None:
            continue
        if name not in params:
            raise KeyError(f"load_flax_sd3_pipeline: no parameters for component {name!r}")
        tree = params[name]
        if name == "vae":
            tree = {k: v for k, v in tree.items() if k not in ("encoder", "quant_conv")}
        module.load_state_dict(flax_to_torch_state_dict(flatten_flax(tree), module, key_map))
    return pipe
