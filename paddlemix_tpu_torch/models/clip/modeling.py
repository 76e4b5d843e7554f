"""CLIP text towers, the vision tower and the dual tower with its
contrastive loss (port of paddlemix_tpu/models/clip/modeling.py:
CLIPTextTransformer, CLIPVisionTransformer, CLIPModule, clip_contrastive_loss).

Module names follow HF transformers (text_model.embeddings.token_embedding,
text_model.encoder.layers.N, text_model.final_layer_norm, text_projection;
vision_model.embeddings.patch_embedding, vision_model.pre_layrnorm, ...,
visual_projection, logit_scale). Every LayerNorm of the towers runs on the
B10 kernel (`FusedLayerNorm`). `CLIPModel(config, dtype=torch.bfloat16)`
computes in bf16 over fp32 parameters, as the JAX `CLIPModule(dtype=bf16)`
does over fp32 ones (models/layers.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.convert import CLIP_KEY_MAP
from ...ops.attention import use_flash
from ..layers import EncoderBlock, FusedLayerNorm, Linear, PatchEmbed, set_compute_dtype
from .configuration import CLIPConfig, CLIPTextConfig, CLIPVisionConfig


class CLIPTextEmbeddings(nn.Module):
    compute_dtype: Optional[torch.dtype] = None  # flax Embed's `dtype`

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        x = self.token_embedding(input_ids)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return x + self.position_embedding.weight[None, : input_ids.shape[1]].to(x.dtype)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([
            EncoderBlock(cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                         cfg.hidden_act, cfg.layer_norm_eps)
            for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    """Causal text encoder. Returns (last_hidden, pooled) or, with
    output_hidden_states, (last_hidden, pooled, (embeddings, layer_1, ...))."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, output_hidden_states: bool = False):
        x = self.embeddings(input_ids)
        hidden_states = [x]
        for layer in self.encoder.layers:
            x = layer(x, causal=True)
            hidden_states.append(x)
        x = self.final_layer_norm(x)
        # pool at the first eos token
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        if output_hidden_states:
            return x, pooled, tuple(hidden_states)
        return x, pooled

    def flash_launches(self, seq_len: int) -> int:
        """Flash launches of one batch-1 forward over seq_len tokens (causal)."""
        heads = self.config.num_attention_heads
        q = (1, seq_len, heads, self.config.hidden_size // heads)
        return len(self.encoder.layers) * use_flash(q, q, causal=True)


class _TextTowerIO:
    """`from_pretrained` / `save_pretrained` of a standalone text tower (port
    of the JAX `CLIPTextModel` / `CLIPTextModelWithProjection` IO): a
    `text_encoder/` or `text_encoder_2/` directory with flax- or HF-keyed
    weights. Keys the tower has no parameter for are dropped as JAX drops
    them (the projection of a tower without one, HF's `position_ids`)."""

    flax_key_map = CLIP_KEY_MAP  # its names -> the JAX tower's

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32):
        """The tower of directory `path` (or its `subfolder`) on `device`, its
        parameters in `dtype` (the JAX `from_pretrained(dtype=)`: the tower
        computes in it)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, CLIPTextConfig, cls.flax_key_map, path, device=device,
                               param_dtype=dtype, subfolder=subfolder, drop_unexpected=True,
                               build=cls)

    def save_pretrained(self, directory: str):
        """config.json and flax-keyed model.safetensors, as the JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory)


class CLIPTextModel(_TextTowerIO, nn.Module):
    """Standalone text encoder (SD/SDXL text tower 1)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids, output_hidden_states: bool = False):
        return self.text_model(input_ids, output_hidden_states=output_hidden_states)


class CLIPTextModelWithProjection(_TextTowerIO, nn.Module):
    """Text tower + projection head (SDXL's second text encoder; the
    projection has no bias)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        self.text_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids, output_hidden_states: bool = False):
        out = self.text_model(input_ids, output_hidden_states=output_hidden_states)
        return (out[0], self.text_projection(out[1])) + tuple(out[2:])


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = PatchEmbed(cfg.patch_size, cfg.hidden_size, use_bias=cfg.patch_bias)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1,
                                               cfg.hidden_size)

    def forward(self, pixel_values):
        x = self.patch_embedding(pixel_values)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None].to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    """ViT over NHWC pixels. Returns (last_hidden, pooled) or, with
    output_hidden_states, (last_hidden, pooled, (embeddings, layer_1, ...)).
    Its attention goes to math or flash by the JAX package's shape rule (at
    ViT-L/14-336's 577 tokens and BLIP-2's 257: math). BLIP-2's form
    (`use_pre_layernorm` off, `post_layernorm_full` on) has no pre-LN and
    normalises every token after the last layer: last_hidden is then the
    normalised tokens and pooled their token 0."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = (FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
                             if cfg.use_pre_layernorm else None)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values, output_hidden_states: bool = False):
        x = self.embeddings(pixel_values)
        if self.pre_layrnorm is not None:
            x = self.pre_layrnorm(x)
        hidden_states = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        if self.config.post_layernorm_full:
            x = self.post_layernorm(x)
            pooled = x[:, 0]
        else:
            pooled = self.post_layernorm(x[:, 0])
        if output_hidden_states:
            return x, pooled, tuple(hidden_states)
        return x, pooled


class CLIPVisionModel(nn.Module):
    """Standalone vision tower (LLaVA's)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixel_values, output_hidden_states: bool = False):
        return self.vision_model(pixel_values, output_hidden_states=output_hidden_states)


class CLIPModel(nn.Module):
    """The dual tower (port of `CLIPModule`): both towers, bias-free
    projections to `projection_dim` and a 0-d `logit_scale`. `dtype` is the
    compute dtype (flax's module `dtype`): None computes in the parameters'
    dtype; bf16 casts fp32 parameters where the JAX module casts them."""

    flax_key_map = CLIP_KEY_MAP  # its names -> the JAX CLIPModule's

    def __init__(self, config: CLIPConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        vision, text = config.vision, config.text
        self.vision_model = CLIPVisionTransformer(vision)
        self.text_model = CLIPTextTransformer(text)
        self.visual_projection = Linear(vision.hidden_size, config.projection_dim, bias=False)
        self.text_projection = Linear(text.hidden_size, config.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(float(config.logit_scale_init_value)))
        set_compute_dtype(self, dtype)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: Optional[torch.dtype] = None):
        """The model of directory `path` (config.json and flax- or torch-keyed
        weights, core/modeling.py) on `device`, computing in `dtype`."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, CLIPConfig, cls.flax_key_map, path, device=device,
                               dtype=dtype)

    def encode_image(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values)[1])

    def encode_text(self, input_ids):
        return self.text_projection(self.text_model(input_ids)[1])

    def forward(self, pixel_values, input_ids, normalize: bool = True):
        """(image features, text features, exp(logit_scale)): the features
        (B, projection_dim) in the compute dtype, L2-normalised unless
        `normalize` is False; the scale an fp32 0-d tensor."""
        img = self.encode_image(pixel_values)
        txt = self.encode_text(input_ids)
        if normalize:
            img = img / img.norm(dim=-1, keepdim=True)
            txt = txt / txt.norm(dim=-1, keepdim=True)
        return img, txt, self.logit_scale.exp()


def scaled_logits(scale, a, b):
    """scale * a @ b.T with the JAX package's promotion: an fp32 0-d scale
    makes bf16 features fp32 (torch would keep bf16 for a 0-d operand)."""
    dtype = torch.promote_types(scale.dtype, torch.promote_types(a.dtype, b.dtype))
    return (scale.to(dtype) * a.to(dtype)) @ b.to(dtype).T


def clip_contrastive_loss(image_feats, text_feats, logit_scale, axis_name: Optional[str] = None):
    """InfoNCE over one card's batch (port of `clip_contrastive_loss`): the
    mean of the image->text and text->image cross entropies, pair i the
    label of row i. `axis_name` gathers features across a device mesh in the
    JAX package; the mesh is not ported, so it raises."""
    if axis_name is not None:
        raise NotImplementedError("clip_contrastive_loss: gathering features across a device "
                                  "mesh (axis_name) is not ported")
    labels = torch.arange(image_feats.shape[0], device=image_feats.device)
    loss_i = F.cross_entropy(scaled_logits(logit_scale, image_feats, text_feats), labels)
    loss_t = F.cross_entropy(scaled_logits(logit_scale, text_feats, image_feats), labels)
    return 0.5 * (loss_i + loss_t)
