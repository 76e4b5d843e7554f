"""CLIP text towers and the vision tower (port of
paddlemix_tpu/models/clip/modeling.py: CLIPTextTransformer and
CLIPVisionTransformer).

Module names follow HF transformers (text_model.embeddings.token_embedding,
text_model.encoder.layers.N, text_model.final_layer_norm, text_projection;
vision_model.embeddings.patch_embedding, vision_model.pre_layrnorm, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.attention import use_flash
from ..layers import EncoderBlock, PatchEmbed
from .configuration import CLIPTextConfig, CLIPVisionConfig


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        x = self.token_embedding(input_ids)
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
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

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


class CLIPTextModel(nn.Module):
    """Standalone text encoder (SD/SDXL text tower 1)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids, output_hidden_states: bool = False):
        return self.text_model(input_ids, output_hidden_states=output_hidden_states)


class CLIPTextModelWithProjection(nn.Module):
    """Text tower + projection head (SDXL's second text encoder)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

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
    ViT-L/14-336's 577 tokens: math)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values, output_hidden_states: bool = False):
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        hidden_states = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
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
