"""Stable Diffusion 1.5 at its published widths, with seeded random weights.

The widths are those of the public runwayml/stable-diffusion-v1-5 configs
(unet, vae, text_encoder = CLIP ViT-L/14 text, scheduler = PNDM with
skip_prk_steps), which the JAX package carries as `SD15_UNET_CONFIG`,
`SD15_VAE_CONFIG` and its single-file loader's text config and scheduler
(paddlemix_tpu/diffusers/single_file.py); the dicts below are the port's own
copies. The UNet's `attention_head_dim=8` is a head count (the diffusers
quirk), so its transformer blocks run 8 heads of 40, 80 and 160 over 320,
640 and 1280 channels, with 1x1-conv projections in and out. No checkpoint
is read: weights come from a torch.Generator (core.init), made on the target
device. `load_flax_sd15_pipeline` carries a JAX SD1.5 pipeline's parameters
over.

Training (tools/train_text_to_image.py) takes the UNet alone:
`random_sd15_unet` keeps fp32 masters and computes in bf16, the recipe of
the JAX package's `cast_training_params` under a bf16 module dtype;
`expected_launches_sd15_train` and `unet_train_flops` give a training step's
kernel launches and model flops.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch

from ..core.convert import (
    CLIP_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from ..core.init import build_random
from ..models.clip import CLIPTextConfig, CLIPTextModel, CLIPTokenizer
from ..models.clip.tokenizer import byte_level_tokenizer
from ..models.layers import set_compute_dtype
from ..ops.attention import use_flash
from .models import AutoencoderKL, AutoencoderKLConfig, UNet2DConditionConfig, UNet2DConditionModel
from .models.resnet import n_group_norms
from .pipelines import StableDiffusionPipeline
from .schedulers import PNDMScheduler
from .sdxl import expected_launches, flash_launches_by_dim

SD15_UNET = dict(
    sample_size=64, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D"),
    block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
    cross_attention_dim=768, attention_head_dim=8,
)
SD15_VAE = dict(
    sample_size=512, in_channels=3, out_channels=3, latent_channels=4,
    down_block_types=("DownEncoderBlock2D",) * 4, up_block_types=("UpDecoderBlock2D",) * 4,
    block_out_channels=(128, 256, 512, 512), layers_per_block=2, scaling_factor=0.18215,
)
SD15_TEXT_ENCODER = dict(  # CLIP ViT-L/14 text
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, hidden_act="quick_gelu")
SD15_SCHEDULER = dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
                      skip_prk_steps=True)


def random_sd15_pipeline(device, dtype=torch.bfloat16, seed: int = 0, unet: Dict = SD15_UNET,
                         vae: Dict = SD15_VAE, text_encoder: Dict = SD15_TEXT_ENCODER,
                         tokenizer: Optional[CLIPTokenizer] = None) -> StableDiffusionPipeline:
    """An SD1.5 pipeline with weights drawn on `device` from one seeded
    generator. Feature-map weights are put in channels_last memory."""
    tok = tokenizer or byte_level_tokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype, generator=gen)
    te_cfg = CLIPTextConfig(**text_encoder, eos_token_id=tok.eos_token_id,
                            max_position_embeddings=tok.model_max_length)
    return StableDiffusionPipeline(
        vae=build_random(lambda: AutoencoderKL(AutoencoderKLConfig(**vae)), **kw)
        .to(memory_format=torch.channels_last),
        text_encoder=build_random(lambda: CLIPTextModel(te_cfg), **kw),
        tokenizer=tok,
        unet=build_random(lambda: UNet2DConditionModel(UNet2DConditionConfig(**unet)), **kw)
        .to(memory_format=torch.channels_last),
        scheduler=PNDMScheduler(**SD15_SCHEDULER))


def expected_launches_sd15(pipe: StableDiffusionPipeline, height: int = 512, width: int = 512,
                           num_inference_steps: int = 50, guidance_scale: float = 7.5) -> Dict:
    """Kernel launches one single-prompt call should make, keyed by wrapper
    name, from walking the blocks (`sdxl.expected_launches`), and under
    `flash_attention_by_dim` the flash launches by the caller's head_dim
    (the counter `flash_attention.launches_by_dim`). At 512 px the 15
    self-attentions of a forward over 4,096, 1,024 and 256 tokens take flash
    (5 each at head_dim 40, 80 and 160); the mid block's 64 tokens, the
    77-token cross-attention, the causal text tower and the VAE's 512-wide
    head go to math."""
    out = expected_launches(pipe, height, width, num_inference_steps, guidance_scale)
    out["flash_attention_by_dim"] = dict(flash_launches_by_dim(
        pipe, height, width, num_inference_steps, guidance_scale))
    return out


# pipeline component -> key map of the JAX package's model class
_FLAX_KEY_MAPS = {"unet": UNET_KEY_MAP, "vae": VAE_KEY_MAP, "text_encoder": CLIP_KEY_MAP}


def load_flax_sd15_pipeline(pipe: StableDiffusionPipeline, params: Dict[str, dict]
                            ) -> StableDiffusionPipeline:
    """Load a JAX SD1.5 pipeline's parameters into the port's `pipe`: `params`
    maps `unet`, `vae` and `text_encoder` to their flax params (nested dicts
    of arrays). Every key on both sides must be consumed (see
    `flax_to_torch_state_dict`). Returns `pipe`."""
    for name, key_map in _FLAX_KEY_MAPS.items():
        if name not in params:
            raise KeyError(f"load_flax_sd15_pipeline: no parameters for component {name!r}")
        module = getattr(pipe, name)
        module.load_state_dict(flax_to_torch_state_dict(flatten_flax(params[name]), module,
                                                        key_map))
    return pipe


# ------------------------------------------------------------------ training
def random_sd15_unet(device, seed: int = 0, param_dtype=torch.float32,
                     compute_dtype=torch.bfloat16, unet: Dict = SD15_UNET) -> UNet2DConditionModel:
    """The SD1.5 UNet for training: parameters in `param_dtype` (fp32
    masters) drawn on `device` from a seeded generator, computing in
    `compute_dtype` (None: in the parameters' dtype); feature-map weights in
    channels_last memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_random(lambda: UNet2DConditionModel(UNet2DConditionConfig(**unet)),
                         device=device, dtype=param_dtype, generator=gen)
    return set_compute_dtype(model.to(memory_format=torch.channels_last), compute_dtype)


def attention_sites(model):
    """((part, block index), down level, Transformer2DModel) of every spatial
    transformer of a UNet or a ControlNet: part "down", "mid" or "up"."""
    n = len(model.config.block_out_channels)
    for i, blk in enumerate(model.down_blocks):
        for t in getattr(blk, "attentions", None) or []:
            yield ("down", i), i, t
    for t in model.mid_block.attentions:
        yield ("mid", 0), n - 1, t
    for i, blk in enumerate(getattr(model, "up_blocks", ())):
        for t in getattr(blk, "attentions", None) or []:
            yield ("up", i), n - 1 - i, t


def _blocks(model):
    """((part, block index), block) of a UNet's or a ControlNet's blocks."""
    yield from ((("down", i), b) for i, b in enumerate(model.down_blocks))
    yield ("mid", 0), model.mid_block
    yield from ((("up", i), b) for i, b in enumerate(getattr(model, "up_blocks", ())))


def train_walk(model, batch: int, latent_hw: int, steps: int = 1, context_len: int = 77,
               grad=lambda site: True) -> Counter:
    """Kernel launches of `steps` training forwards and backwards of `model`
    (a UNet or a ControlNet) over `batch` latents of latent_hw x latent_hw,
    from walking its blocks. `grad(site)` says whether the attention of a
    block ((part, index), as `attention_sites` names it) sees a gradient:
    each of its calls that `use_flash` sends to flash runs the lse forward
    (B15) and the two backward kernels (B14) once, under the model's
    `gradient_checkpointing` the forward twice (the block recomputed); a
    call without a gradient runs the inference form (B1) once. Every
    GroupNorm runs its forward kernel (B4) once, twice in a recomputed
    block: its backward is autograd of the plain version. Keys: the wrappers'
    names, and `(name, head_dim)` for the flash ones."""
    recompute = 2 if model.config.gradient_checkpointing else 1
    out = Counter()
    for site, level, tf in attention_sites(model):
        tokens = (latent_hw >> level) ** 2
        for blk in tf.transformer_blocks:
            heads, hd = blk.attn1.num_heads, blk.attn1.head_dim
            q = (batch, tokens, heads, hd)
            n = steps * (use_flash(q, q) + use_flash(q, (batch, context_len, heads, hd)))
            names = ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq") if grad(site) else \
                ("flash_attention",)
            for name in names:
                k = n * recompute if name == "flash_fwd_lse" else n
                out[name] += k
                out[name, hd] += k
    in_blocks = 0
    for site, blk in _blocks(model):
        norms = n_group_norms(blk)
        in_blocks += norms
        out["group_norm"] += steps * norms * (recompute if grad(site) else 1)
    out["group_norm"] += steps * (n_group_norms(model) - in_blocks)
    return +out


def keyed(walk: Counter) -> Dict:
    """A `train_walk` Counter as {wrapper: launches}, with `by_dim`
    {wrapper: {head_dim: launches}}."""
    out = {k: v for k, v in walk.items() if isinstance(k, str)}
    out["by_dim"] = {}
    for k, v in walk.items():
        if isinstance(k, tuple):
            out["by_dim"].setdefault(k[0], {})[k[1]] = v
    return out


def expected_launches_sd15_train(unet: UNet2DConditionModel, batch: int, latent_hw: int,
                                 steps: int = 1, context_len: int = 77) -> Dict:
    """Kernel launches of `steps` training micro-batches of `batch` latents
    of latent_hw x latent_hw (forward and backward), keyed by wrapper name,
    from walking the blocks (`train_walk`, every block training): at 64x64
    latents the 15 self-attentions over 4,096, 1,024 and 256 tokens run the
    lse forward (B15) and the two backward kernels (B14), 5 at each head_dim
    40, 80 and 160 (B15 twice under `gradient_checkpointing`); the mid
    block's 64 tokens and the 77-key cross-attention take math; every
    GroupNorm its forward kernel (B4) once (twice inside a recomputed
    block). Under `flash_by_dim`, the flash calls by the caller's head_dim
    (B14's, the backward's `launches_by_dim`)."""
    walk = keyed(train_walk(unet, batch, latent_hw, steps, context_len))
    return {"flash_fwd_lse": walk["flash_fwd_lse"], "flash_bwd_dkv": walk["flash_bwd_dkv"],
            "flash_bwd_dq": walk["flash_bwd_dq"], "group_norm": walk["group_norm"],
            "flash_by_dim": walk["by_dim"]["flash_bwd_dkv"]}


def unet_train_flops(unet: UNet2DConditionModel, batch: int, latent_hw: int,
                     context_len: int = 77) -> int:
    """Model flops of one training micro-batch: 3x the forward's (the
    backward's dX and dW each cost a forward), the forward counted from the
    modules' widths at the spatial size each runs at: 2 flops a weight an
    output position for every conv and Linear, 4 D flops a (query, key) pair
    for attention. Norms, activations and the timestep sinusoids are left
    out."""
    def conv(m, side):
        return 2 * m.in_channels * m.out_channels * m.kernel_size[0] * m.kernel_size[1] \
            * side * side // m.groups

    def linear(m, rows):
        return 2 * m.in_features * m.out_features * rows

    def proj(m, side):
        return linear(m, side * side) if isinstance(m, torch.nn.Linear) else conv(m, side)

    def resnet(r, side):
        return conv(r.conv1, side) + conv(r.conv2, side) + linear(r.time_emb_proj, 1) + (
            conv(r.conv_shortcut, side) if r.conv_shortcut is not None else 0)

    def transformer(tf, side):
        t = side * side
        f = proj(tf.proj_in, side) + proj(tf.proj_out, side)
        for blk in tf.transformer_blocks:
            a1, a2 = blk.attn1, blk.attn2
            inner = a1.num_heads * a1.head_dim
            f += sum(linear(m, t) for m in (a1.to_q, a1.to_k, a1.to_v, a1.to_out[0]))
            f += linear(a2.to_q, t) + linear(a2.to_out[0], t)
            f += linear(a2.to_k, context_len) + linear(a2.to_v, context_len)
            f += 4 * inner * t * (t + context_len)
            f += linear(blk.ff.net[0].proj, t) + linear(blk.ff.net[2], t)
        return f

    def level_blocks(blk, side):
        f = sum(resnet(r, side) for r in blk.resnets)
        return f + sum(transformer(tf, side) for tf in getattr(blk, "attentions", None) or [])

    n = len(unet.config.block_out_channels)
    te = unet.time_embedding
    f = conv(unet.conv_in, latent_hw) + conv(unet.conv_out, latent_hw)
    f += linear(te.linear_1, 1) + linear(te.linear_2, 1)
    for i, blk in enumerate(unet.down_blocks):
        side = latent_hw >> i
        f += level_blocks(blk, side)
        if blk.downsamplers is not None:
            f += conv(blk.downsamplers[0].conv, side // 2)
    f += level_blocks(unet.mid_block, latent_hw >> (n - 1))
    for i, blk in enumerate(unet.up_blocks):
        side = latent_hw >> (n - 1 - i)
        f += level_blocks(blk, side)
        if blk.upsamplers is not None:
            f += conv(blk.upsamplers[0].conv, 2 * side)
    return 3 * batch * f
