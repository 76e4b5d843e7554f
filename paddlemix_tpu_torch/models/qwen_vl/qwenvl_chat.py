"""Qwen-VL-Chat (Qwen/Qwen-VL-Chat; configs/qwen_vl/*.json name Qwen-VL-7B,
its base) at its published widths, with seeded random weights.

Widths: the published config.json and its `visual` block. The tower is
ViT-bigG: 448 px, patches of 14 (1,024 tokens, no class token), 1,664 wide,
48 layers, 16 heads of 104, MLP ratio 4.9231 (8,192), a 16 x 16 position
table resized to the 32 x 32 grid; the Resampler's 256 queries, 32 heads of
128, out 4,096. The language model is Qwen-7B: vocab 151,936, 4,096 wide, 32
layers, 32 heads of 128 (no GQA), w1 / w2 11,008 each (the Llama's up and
gate), RMSNorm eps 1e-6, rope base 10,000, seq_length 2,048 with logn
attention on (`use_dynamic_ntk`: the NTK alpha a context needs is
`LlamaConfig.ntk_alpha_for`, 1 up to 2,048 tokens), q / k / v biases, an
untied lm_head. About 9.66 B parameters. No checkpoint is read: weights
come from a torch.Generator (core.init), made on the target device, in
`dtype` (bf16 by default; the norms' weights and biases in fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ...core.init import build_random
from ...ops.attention import use_flash
from ..layers import FusedLayerNorm, n_layer_norms
from ..llama.modeling import LlamaAttention, RMSNorm
from .modeling import QwenVLConfig, QwenVLForConditionalGeneration

QWEN_VL_CHAT = dict(
    vision_config=dict(image_size=448, patch_size=14, width=1664, layers=48, heads=16,
                       mlp_ratio=4.9231, output_dim=4096),
    text_config=dict(vocab_size=151936, hidden_size=4096, intermediate_size=11008,
                     num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                     max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
                     tie_word_embeddings=False, bos_token_id=151643, eos_token_id=151643,
                     use_logn_attn=True, logn_seq_length=2048, rope_ntk_alpha=1.0),
    num_queries=256, image_token_id=151857,
)
IMG_START_ID, IMG_END_ID = 151857, 151858  # <img>, </img>
TEXT_ID_LIMIT = 151643  # prompt ids are drawn below the special ids (<|endoftext|> on)
PROMPT_TEXT_LEN = 32
NEW_TOKENS = 128


def qwenvl_chat_config() -> QwenVLConfig:
    return QwenVLConfig.from_dict(QWEN_VL_CHAT)


def random_qwen_vl(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                   config: QwenVLConfig = None) -> QwenVLForConditionalGeneration:
    """Qwen-VL (by default Qwen-VL-Chat) with weights drawn on `device` from
    one seeded generator, in `dtype` but for the norms' (fp32)."""
    cfg = config or qwenvl_chat_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: QwenVLForConditionalGeneration(cfg), device=device, dtype=dtype,
                        generator=gen, fp32_modules=(RMSNorm, FusedLayerNorm))


def set_ntk_alpha(model: QwenVLForConditionalGeneration, context_length: int) -> float:
    """Set the language model's NTK alpha to the one QWen's dynamic NTK
    takes at `context_length` (`ntk_alpha_for`; the JAX package fixes it
    for the compiled context alike). Returns the alpha."""
    lm = model.language_model
    alpha = lm.config.ntk_alpha_for(context_length)
    lm.config = lm.model.config = dataclasses.replace(lm.config, rope_ntk_alpha=alpha)
    return alpha


def prompt_ids(config: QwenVLConfig, images: int, text_len: int = PROMPT_TEXT_LEN,
               seed: int = 0, filler: int = 0) -> torch.Tensor:
    """A request's prompt (1, S) int64 in `from_list_format`'s order: for each
    image, `filler` seeded text ids (its "Picture i: " label), then <img>'s
    span: the placeholder id num_queries times and </img>; then `text_len`
    seeded ids below the special ids (no tokenizer files are in the
    repository). The placeholder is JAX's `image_token_id` (151,857), so the
    span's first id is the placeholder itself."""
    g = torch.Generator().manual_seed(seed)
    draw = lambda n: torch.randint(0, TEXT_ID_LIMIT, (n,), generator=g)  # noqa: E731
    parts = []
    for _ in range(images):
        parts += [draw(filler), torch.full((config.num_queries,), config.image_token_id),
                  torch.tensor([IMG_END_ID])]
    parts.append(draw(text_len))
    return torch.cat(parts).long()[None]


def expected_launches_qwen_vl(model: QwenVLForConditionalGeneration, prompt_len: int,
                              new_tokens: int, images: int = 0) -> Dict[str, int]:
    """Kernel launches of one batch-1 `generate` of `new_tokens` over a prompt
    of `prompt_len` ids with `images` images (0: text alone), from walking the
    modules: the tower runs once over the images, each of its LayerNorms
    launching B10 once (ln_pre, 2 a block, ln_kv, ln_q, ln_post), its 48
    blocks' attention and the Resampler's going to flash (B1) or math by
    `use_flash`; the language model runs new_tokens forwards, each launching
    its RMSNorms, and every single-token forward launches B7 once a layer.
    The prefill over the cache runs math attention."""
    v = model.config.vision
    lm = model.language_model
    single_token_forwards = new_tokens - 1 + (prompt_len == 1)
    n = (v.image_size // v.patch_size) ** 2
    q = (images, n, v.heads, v.width // v.heads)
    pool = model.visual.attn_pool
    qr = (images, pool.query.shape[0], pool.num_heads, v.output_dim // pool.num_heads)
    kr = (images, n, pool.num_heads, v.output_dim // pool.num_heads)
    count = lambda kind: sum(isinstance(m, kind) for m in lm.modules())  # noqa: E731
    return {
        "rms_norm": count(RMSNorm) * new_tokens,
        "decode_attention": count(LlamaAttention) * single_token_forwards,
        "layer_norm": n_layer_norms(model.visual) if images else 0,
        "flash_attention": v.layers * use_flash(q, q) + use_flash(qr, kr) if images else 0,
    }
