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

`save_published_sd3` writes a pipeline in the published directory's layout
and file names (diffusers' and transformers' keys and configs, T5 in
shards), which `DiffusionPipeline.from_pretrained` reads back with
`tokenizer_3=seeded_t5_tokenizer(...)` as an override. Training:
`image_latents` encodes images as the pipeline's decode inverts them,
`sd3_trainer` is the Trainer of the flow-match loss at
`train_text_to_image`'s arguments, and `expected_launches_sd3_train` walks
its launches.
"""

from __future__ import annotations

import json
import os
import zlib
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from ..core import safetensors as st
from ..core.convert import (
    CLIP_KEY_MAP,
    SD3_KEY_MAP,
    T5_KEY_MAP,
    VAE_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from ..core.init import build_random
from ..core.modeling import DIFFUSERS_SAFETENSORS_NAME, MAX_SHARD_BYTES, save_state_dict
from ..datasets import DataLoader, MapDataset
from ..models.clip import CLIPTextConfig, CLIPTextModelWithProjection, CLIPTokenizer
from ..models.clip.tokenizer import byte_level_tokenizer
from ..models.layers import n_layer_norms
from ..models.t5 import T5Config, T5EncoderModel, T5LayerNorm
from ..ops.attention import use_flash
from ..trainer import Trainer, TrainingArguments
from .models import AutoencoderKL, AutoencoderKLConfig, SD3Transformer2DModel, SD3TransformerConfig
from .models.resnet import n_group_norms
from .models.transformer_sd3 import DIFFUSERS_POS_EMBED_KEY, diffusers_state_dict
from .pipelines import StableDiffusion3Pipeline
from .pipelines.stable_diffusion_3 import T5_SEQ_LEN
from .schedulers import FlowMatchEulerDiscreteScheduler
from .training_utils import make_flow_match_loss_fn

SD3_TRANSFORMER = dict(sample_size=128, patch_size=2, in_channels=16, num_layers=24,
                       attention_head_dim=64, num_attention_heads=24, joint_attention_dim=4096,
                       pooled_projection_dim=2048, out_channels=16)
SD3_VAE = dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
               use_quant_conv=False, use_post_quant_conv=False)
SD3_TEXT_ENCODER = dict(  # CLIP ViT-L/14 text + projection
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, hidden_act="quick_gelu", projection_dim=768)
SD3_TEXT_ENCODER_2 = dict(  # OpenCLIP ViT-bigG/14 text + projection
    vocab_size=49408, hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
    num_attention_heads=20, hidden_act="gelu", projection_dim=1280)
SD3_TEXT_ENCODER_3 = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
                          num_heads=64, layer_norm_epsilon=1e-6)
SD3_SCHEDULER = dict(shift=3.0)
DIFFUSERS_VERSION = "0.29.0.dev0"  # the published directory's
# the published scheduler/scheduler_config.json
SD3_SCHEDULER_CONFIG = dict(_class_name="FlowMatchEulerDiscreteScheduler",
                            _diffusers_version=DIFFUSERS_VERSION, num_train_timesteps=1000,
                            shift=3.0)


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
    Every key on both sides must be consumed (see
    `flax_to_torch_state_dict`). Returns `pipe`."""
    for name, key_map in _FLAX_KEY_MAPS.items():
        module = getattr(pipe, name)
        if module is None:
            continue
        if name not in params:
            raise KeyError(f"load_flax_sd3_pipeline: no parameters for component {name!r}")
        module.load_state_dict(flax_to_torch_state_dict(flatten_flax(params[name]), module,
                                                         key_map))
    return pipe


def diffusers_pos_embed_table(embed_dim: int, max_size: int, base_size: int,
                              device=None) -> torch.Tensor:
    """diffusers' stored `pos_embed.pos_embed` (1, max_size ** 2, embed_dim)
    fp32: the 2-D sincos table of a max_size x max_size grid whose position i
    is i / (max_size / base_size), computed in float64 as diffusers computes
    it. diffusers crops its centre for a smaller grid; the port and JAX do
    not read it (ROADMAP C.25)."""
    pos = torch.arange(max_size, dtype=torch.float64, device=device) / (max_size / base_size)
    mesh_w, mesh_h = torch.meshgrid(pos, pos, indexing="xy")

    def sincos(dim, p):
        omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64, device=device)
                                / (dim / 2.0))
        out = p.reshape(-1)[:, None] * omega[None]
        return torch.cat([out.sin(), out.cos()], dim=1)

    table = torch.cat([sincos(embed_dim // 2, mesh_w), sincos(embed_dim // 2, mesh_h)], dim=1)
    return table.float()[None]


def _config_json(directory: str, cfg: Dict) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def _fields(config) -> Dict:
    return {k: v for k, v in config.to_dict().items() if k not in ("model_type", "_class_name")}


def save_published_sd3(pipe: StableDiffusion3Pipeline, path: str,
                       max_shard_bytes: int = MAX_SHARD_BYTES) -> Dict[str, int]:
    """`pipe` in the published stabilityai/stable-diffusion-3-medium-diffusers
    layout under `path`: model_index.json; transformer/ and vae/ as diffusers
    writes them (config.json with `_class_name`, diffusers' keys in
    `diffusion_pytorch_model.safetensors`; the transformer's with diffusers'
    stored position table); text_encoder/ and text_encoder_2/ (transformers'
    CLIPTextModelWithProjection: config.json, `model.safetensors`) and
    text_encoder_3/ (transformers' T5EncoderModel: config.json, `shared.weight`
    and the encoder's keys in `model-0000i-of-0000n.safetensors` shards of at
    most `max_shard_bytes`, with their index); tokenizer/ and tokenizer_2/
    (vocab.json, merges.txt); tokenizer_3/ (its tokenizer_config.json alone:
    the repository holds no T5 vocabulary); scheduler/scheduler_config.json.
    Each tensor is written in its own dtype as it is brought to the host.
    Returns {relative file name: bytes} of the weights."""
    written: Dict[str, int] = {}
    tr, vae = pipe.transformer, pipe.vae
    sub = os.path.join(path, "transformer")
    _config_json(sub, dict(_fields(tr.config), _class_name="SD3Transformer2DModel",
                           _diffusers_version=DIFFUSERS_VERSION,
                           caption_projection_dim=tr.config.hidden_size))
    flat = diffusers_state_dict(tr)
    cfg = tr.config
    flat[DIFFUSERS_POS_EMBED_KEY] = diffusers_pos_embed_table(
        cfg.hidden_size, cfg.pos_embed_max_size, cfg.sample_size // cfg.patch_size,
        tr.proj_out.weight.device).to(tr.proj_out.weight.dtype)
    written["transformer/" + DIFFUSERS_SAFETENSORS_NAME] = st.save_file(
        flat, os.path.join(sub, DIFFUSERS_SAFETENSORS_NAME))
    del flat
    sub = os.path.join(path, "vae")
    _config_json(sub, dict(_fields(vae.config), _class_name="AutoencoderKL",
                           _diffusers_version=DIFFUSERS_VERSION))
    written["vae/" + DIFFUSERS_SAFETENSORS_NAME] = st.save_file(
        dict(vae.state_dict()), os.path.join(sub, DIFFUSERS_SAFETENSORS_NAME))
    index = {"_class_name": "StableDiffusion3Pipeline", "_diffusers_version": DIFFUSERS_VERSION,
             "transformer": ["diffusers", "SD3Transformer2DModel"],
             "vae": ["diffusers", "AutoencoderKL"],
             "scheduler": ["diffusers", "FlowMatchEulerDiscreteScheduler"]}
    for name in ("text_encoder", "text_encoder_2"):
        enc = getattr(pipe, name)
        sub = os.path.join(path, name)
        _config_json(sub, dict(_fields(enc.config), architectures=["CLIPTextModelWithProjection"],
                               model_type="clip_text_model"))
        written[f"{name}/model.safetensors"] = st.save_file(
            dict(enc.state_dict()), os.path.join(sub, "model.safetensors"))
        index[name] = ["transformers", "CLIPTextModelWithProjection"]
    for name in ("tokenizer", "tokenizer_2"):
        getattr(pipe, name).save_pretrained(os.path.join(path, name))
        index[name] = ["transformers", "CLIPTokenizer"]
    if pipe.text_encoder_3 is not None:
        t5 = pipe.text_encoder_3
        sub = os.path.join(path, "text_encoder_3")
        _config_json(sub, dict(_fields(t5.config), architectures=["T5EncoderModel"],
                               model_type="t5"))
        files = save_state_dict(dict(t5.state_dict()), sub, max_shard_bytes)
        written.update({f"text_encoder_3/{k}": v for k, v in files.items()})
        os.makedirs(os.path.join(path, "tokenizer_3"))
        with open(os.path.join(path, "tokenizer_3", "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "T5Tokenizer", "model_max_length": 512,
                       "eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>"}, f,
                      indent=2)
        index.update(text_encoder_3=["transformers", "T5EncoderModel"],
                     tokenizer_3=["transformers", "T5TokenizerFast"])
    else:
        index.update(text_encoder_3=[None, None], tokenizer_3=[None, None])
    os.makedirs(os.path.join(path, "scheduler"))
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(SD3_SCHEDULER_CONFIG, f, indent=2)
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return written


@torch.inference_mode()
def image_latents(vae: AutoencoderKL, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC pixels in [-1, 1] -> (B, H/8, W/8, latent) fp32
    training latents: the posterior's mode, shifted and scaled as the
    pipeline's decode inverts it, (z - shift_factor) * scaling_factor."""
    cfg = vae.config
    z = vae.encode(pixels).mode().float()
    if cfg.shift_factor:
        z = z - cfg.shift_factor
    return z * cfg.scaling_factor


def sd3_trainer(transformer: SD3Transformer2DModel, scheduler, samples, batch_size: int = 2,
                **overrides) -> Trainer:
    """The Trainer of SD3's flow-match loss (`make_flow_match_loss_fn`, shift
    from the scheduler's config) over `samples` (dicts of "latents",
    "encoder_hidden_states", "pooled_projections"), at
    `train_text_to_image.build_trainer`'s arguments: AdamW at lr 1e-5 under
    the TrainingArguments defaults, max_steps 1000, logging every 10, no
    checkpoints, shuffled batches of `batch_size`; `overrides` replace
    TrainingArguments fields. JAX has no SD3 training example to take them
    from."""
    loss_fn = make_flow_match_loss_fn(transformer, scheduler, shift=scheduler.config.shift)
    args = TrainingArguments(**dict(dict(output_dir="output/sd3", learning_rate=1e-5,
                                         max_steps=1000, logging_steps=10, save_steps=0,
                                         benchmark=True), **overrides))
    loader = DataLoader(MapDataset(samples), batch_size=batch_size, shuffle=True)
    return Trainer(model=transformer, args=args, loss_fn=loss_fn, train_dataloader=loader)


def expected_launches_sd3_train(transformer: SD3Transformer2DModel, batch: int, latent_hw: int,
                                context_len: int, steps: int = 1) -> Dict[str, int]:
    """Kernel launches of `steps` training micro-batches of `batch` latents of
    latent_hw x latent_hw with `context_len` context tokens, keyed by wrapper
    name, from walking the blocks: each joint attention that `use_flash`
    sends to flash runs the lse forward (B15) and the two backward kernels
    (B14) once; each block runs two adaLN (B12) and one or two fused adaLN +
    residual (B13) forwards, their backward autograd of the plain versions;
    `norm_out` one more adaLN. With gradient checkpointing every block's
    forward kernels run twice (the forward and the recompute)."""
    cfg = transformer.config
    tokens = (latent_hw // cfg.patch_size) ** 2 + context_len
    runs = 2 if cfg.gradient_checkpointing else 1
    out = Counter(adaptive_layer_norm=steps)  # norm_out
    for blk in transformer.transformer_blocks:
        q = (batch, tokens, blk.num_heads, blk.head_dim)
        flash = use_flash(q, q)
        out["adaptive_layer_norm"] += 2 * runs * steps
        out["fused_adaln_scale_residual"] += (1 if blk.context_pre_only else 2) * runs * steps
        out["flash_fwd_lse"] += flash * runs * steps
        out["flash_bwd_dkv"] += flash * steps
        out["flash_bwd_dq"] += flash * steps
    return dict(out)
