"""InternVL2-8B (OpenGVLab/InternVL2-8B, the model of
configs/internvl2/sft_8b.json) at its published widths, with seeded random
weights.

Widths: the published config.json. The tower is InternViT-300M-448px: 24
layers, 1,024 wide, 16 heads of 64, MLP 4,096, LayerNorms (eps 1e-6), no qk
norm, 448 px tiles of 14 px patches (1,025 tokens). The projector: the
pixel-unshuffled 4,096-wide features, LayerNorm, 4,096 -> 4,096 -> 4,096.
The language model is InternLM2.5-7B: vocab 92,553, 4,096 wide, MLP 14,336,
32 layers, 32 query heads on 8 KV heads of 128 (GQA group 4), RMSNorm eps
1e-5, rope theta 1e6, an untied lm_head. `img_context_token_id` is the
tokenizer's <IMG_CONTEXT>, 92,546 (JAX's default lies past the vocab, ROADMAP
C.42). About 8.08 B parameters. No checkpoint is read: weights come from a
torch.Generator (core.init), made on the target device, in `dtype` (bf16 by
default; the norms' weights and biases in fp32).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ...core.init import build_random
from ...ops.attention import use_flash
from ..layers import FusedLayerNorm, n_layer_norms
from ..llama.modeling import LlamaAttention, RMSNorm
from .modeling import InternVLChatConfig, InternVLChatModel

INTERNVL2_8B = dict(
    vision_config=dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                       num_attention_heads=16, image_size=448, patch_size=14, qkv_bias=True,
                       qk_normalization=False, norm_type="layer_norm", layer_norm_eps=1e-6,
                       initializer_factor=0.1),
    llm_config=dict(vocab_size=92553, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1000000.0,
                    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2),
    downsample_ratio=0.5, select_layer=-1, ps_version="v2", img_context_token_id=92546,
)
IMG_START_ID, IMG_END_ID = 92544, 92545  # <img>, </img>
TEXT_ID_LIMIT = 92538  # prompt ids are drawn below the special ids
PROMPT_TEXT_LEN = 32   # text ids after the image
NEW_TOKENS = 128


def internvl2_8b_config() -> InternVLChatConfig:
    return InternVLChatConfig.from_dict(INTERNVL2_8B)


def random_internvl2(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                     config: InternVLChatConfig = None) -> InternVLChatModel:
    """InternVL2 (by default 8B) with weights drawn on `device` from one
    seeded generator, in `dtype` but for the norms' (fp32)."""
    cfg = config or internvl2_8b_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: InternVLChatModel(cfg), device=device, dtype=dtype,
                        generator=gen, fp32_modules=(RMSNorm, FusedLayerNorm))


def prompt_ids(config: InternVLChatConfig, tiles: Sequence[int],
               text_len: int = PROMPT_TEXT_LEN, seed: int = 0) -> torch.Tensor:
    """A request's prompt (1, S) int64: for each image of `tiles` tiles,
    <img>, tokens_per_tile x tiles image-context ids and </img> (the published
    chat template's image span); then `text_len` ids drawn from a seeded
    generator below the special ids (no tokenizer files are in the
    repository)."""
    ids = []
    for n in tiles:
        ids += [IMG_START_ID] + [config.img_context_token_id] * (config.tokens_per_tile * n) \
            + [IMG_END_ID]
    text = torch.randint(0, TEXT_ID_LIMIT, (text_len,),
                         generator=torch.Generator().manual_seed(seed))
    return torch.cat([torch.tensor(ids, dtype=torch.long), text])[None]


def expected_launches_internvl2(model: InternVLChatModel, prompt_len: int, new_tokens: int,
                                tiles: int = 0) -> Dict[str, int]:
    """Kernel launches of one batch-1 `generate` of `new_tokens` over a prompt
    of `prompt_len` ids with `tiles` real tiles (0: text alone), from walking
    the modules: the tower runs once over the tiles up to the selected
    layer, each of its LayerNorms launching B10 once (2 a layer) and its
    attention going to flash (B1) or math by `use_flash` at 1,025 tokens
    (flash); the projector's LayerNorm launches B10 once; the language model
    runs new_tokens forwards, each launching its RMSNorms (2 a layer and the
    final), and every single-token forward launches B7 once a layer. The
    prefill over the cache runs math attention."""
    cfg = model.config
    v = cfg.vision
    lm = model.language_model
    layers = cfg.select_layer % (v.num_hidden_layers + 1)
    single_token_forwards = new_tokens - 1 + (prompt_len == 1)
    n = (v.image_size // v.patch_size) ** 2 + 1
    q = (tiles, n, v.num_attention_heads, v.hidden_size // v.num_attention_heads)
    count = lambda kind: sum(isinstance(m, kind) for m in lm.modules())  # noqa: E731
    per_layer = n_layer_norms(model.vision_model.layers[0])
    return {
        "rms_norm": count(RMSNorm) * new_tokens,
        "decode_attention": count(LlamaAttention) * single_token_forwards,
        "layer_norm": per_layer * layers + 1 if tiles else 0,
        "flash_attention": layers * use_flash(q, q) if tiles else 0,
    }
