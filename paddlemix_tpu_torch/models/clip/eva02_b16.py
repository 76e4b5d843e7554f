"""EVA02-CLIP-B/16 at its published widths, with seeded random weights.

The configuration is EVA-CLIP's published `EVA02-CLIP-B-16.json`
(baaivision/EVA, EVA-CLIP `model_configs`), the model that
configs/eva_clip/pretrain_b16.json trains (`eva-clip-b-16`). Vision: 224 px,
patch 16 (196 patches and CLS: 197 tokens), width 768, 12 layers, heads of 64,
mlp_ratio 2.6667 (SwiGLU hidden 2,048), rope with pt_hw_seq_len 16 and
intp_freq, naiveswiglu, subln, q/v bias. Text: the CLIP text tower, width 512,
8 heads, 12 layers, MLP 2,048, 77 positions, vocab 49,408, with open_clip's
nn.GELU (the exact gelu, not quick-gelu). embed_dim 512. No checkpoint is
read: fp32 weights come from a torch.Generator (core.init), made on the
target device, and the model computes in bf16 over them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...core.init import build_random
from ..layers import n_layer_norms
from .eva import EVACLIP, EVACLIPConfig

EVA02_B16 = EVACLIPConfig(
    embed_dim=512,
    vision_cfg=dict(image_size=224, patch_size=16, width=768, layers=12, head_width=64,
                    mlp_ratio=2.6667, rope=True, pt_hw_seq_len=16, intp_freq=True,
                    naiveswiglu=True, subln=True, qkv_bias=True),
    text_cfg=dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                  num_hidden_layers=12, num_attention_heads=8, max_position_embeddings=77,
                  hidden_act="gelu"),
)


def random_eva_clip(device="cuda", seed: int = 0, config: EVACLIPConfig = EVA02_B16) -> EVACLIP:
    """An EVACLIP (by default EVA02-CLIP-B/16) with fp32 weights drawn on
    `device` from one seeded generator, computing in bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: EVACLIP(config, dtype=torch.bfloat16), device=device,
                        dtype=torch.float32, generator=gen)


def expected_launches_eva_clip(model: EVACLIP, image_forwards: int = 0, text_forwards: int = 0,
                               backwards: int = 0) -> Dict[str, int]:
    """B10 launches of `image_forwards` vision and `text_forwards` text tower
    forwards and `backwards` dual-tower backwards, from walking the modules:
    every FusedLayerNorm runs once a forward of its tower (EVA02-B/16: 4 a
    block and the pooled `norm`, 49; the text tower 2 a layer and the final
    LN, 25) and has a backward, since all parameters train. Attention at 197
    and 77 tokens is math (`use_flash`), so no other kernel runs."""
    vision, text = n_layer_norms(model.visual), n_layer_norms(model.text_model)
    return {"layer_norm": vision * image_forwards + text * text_forwards,
            "layer_norm_backward": (vision + text) * backwards}
