"""BLIP-2 OPT-2.7B (Salesforce/blip2-opt-2.7b, the model configs/blip2/*.json
name) at its published widths, with seeded random weights.

Widths: the ViT-g tower of transformers' `Blip2VisionConfig` defaults (1,408
wide, MLP 6,144, 39 layers, 16 heads of 88, patch 14 at 224 px: 257 tokens,
exact gelu, eps 1e-6), the Q-Former of `Blip2QFormerConfig` (768 wide, 12
layers, 12 heads, MLP 3,072, cross-attention every 2 layers over the 1,408-wide
image tokens, eps 1e-12), 32 query tokens, and OPT-2.7B, the JAX `OPTConfig`
defaults (2,560 wide, FFN 10,240, 32 layers, 32 heads of 80, vocab 50,272,
2,048 positions). About 3.74 B parameters. No checkpoint is read: weights
come from a torch.Generator (core.init), made on the target device, in
`dtype` (bf16 by default; the LayerNorms' weights and biases in fp32, which
B10 reads beside bf16 rows).
"""

from __future__ import annotations

from typing import Dict

import torch

from ...core.init import build_random
from ...ops.attention import use_flash
from ..layers import FusedLayerNorm, n_layer_norms
from ..opt.modeling import OPTAttention
from .configuration import Blip2Config
from .modeling import Blip2ForConditionalGeneration

BLIP2_OPT_2_7B = dict(
    vision_config=dict(hidden_size=1408, intermediate_size=6144, num_hidden_layers=39,
                       num_attention_heads=16, image_size=224, patch_size=14,
                       hidden_act="gelu", layer_norm_eps=1e-6),
    qformer_config=dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                        intermediate_size=3072, cross_attention_frequency=2,
                        encoder_hidden_size=1408, layer_norm_eps=1e-12),
    text_config=dict(vocab_size=50272, hidden_size=2560, ffn_dim=10240, num_hidden_layers=32,
                     num_attention_heads=32, max_position_embeddings=2048),
    num_query_tokens=32,
)
BOS_ID = 2                # OPT's BOS: the captioning prompt's one id
CAPTION_NEW_TOKENS = 32   # `generate`'s default, as the JAX package's


def random_blip2(seed: int = 0, device="cuda", dtype=torch.bfloat16,
                 config: Blip2Config = None) -> Blip2ForConditionalGeneration:
    """BLIP-2 (by default OPT-2.7B) with weights drawn on `device` from one
    seeded generator, in `dtype` but for the LayerNorms' (fp32)."""
    cfg = config or Blip2Config.from_dict(BLIP2_OPT_2_7B)
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: Blip2ForConditionalGeneration(cfg), device=device, dtype=dtype,
                        generator=gen, fp32_modules=(FusedLayerNorm,))


def expected_launches_blip2(model: Blip2ForConditionalGeneration, prompt_len: int,
                            new_tokens: int) -> Dict[str, int]:
    """Kernel launches of one batch-1 `generate` of `new_tokens` over a prompt
    of `prompt_len` ids, from walking the modules: the tower and the Q-Former
    run once, each of their LayerNorms launching B10 once (OPT-2.7B: 39 x 2 +
    the full post-LN = 79, and 1 + 12 x 2 + 6 cross = 31); the language model
    runs new_tokens forwards (the prefill over the 32 query features and the
    prompt, then a decode step a token after the first), each launching its
    LayerNorms (32 x 2 + the final = 65), and every single-token forward
    launches B7 once a layer. Attention at the tower's 257 tokens, the
    Q-Former's 32 queries and the prefill goes to math (`use_flash`; counted
    here should a config send one to flash)."""
    cfg = model.config
    lm = model.language_model
    vcfg, qcfg = cfg.vision, cfg.qformer
    full = cfg.num_query_tokens + prompt_len
    single_token_forwards = new_tokens - 1 + (full == 1)
    tokens = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    hv, hq = vcfg.num_attention_heads, qcfg.num_attention_heads
    vq = (1, tokens, hv, vcfg.hidden_size // hv)
    qq = (1, cfg.num_query_tokens, hq, qcfg.hidden_size // hq)
    qk = (1, tokens, hq, qcfg.hidden_size // hq)
    n_cross = sum(layer.has_cross for layer in model.qformer.layers)
    return {
        "layer_norm": n_layer_norms(model.vision_model) + n_layer_norms(model.qformer)
        + n_layer_norms(lm) * new_tokens,
        "decode_attention": sum(isinstance(m, OPTAttention) for m in lm.modules())
        * single_token_forwards,
        "flash_attention": vcfg.num_hidden_layers * use_flash(vq, vq)
        + qcfg.num_hidden_layers * use_flash(qq, qq) + n_cross * use_flash(qq, qk),
    }
