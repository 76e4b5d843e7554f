"""LLaVA-1.5-7B at the JAX bench's widths, with seeded random weights.

The widths are the JAX package's LLaVA bench (bench.py, bench_llava_decode):
a CLIP ViT-L/14 tower at 336 px (24 layers, 1024 wide, 16 heads, 577
tokens), the mlp2x_gelu projector (1024 -> 4096 -> 4096) and Llama-7B (32
layers, 4096 wide, 32 heads, MLP 11008, vocab 32000). No checkpoint is read:
weights come from a torch.Generator (core.init), made on the target device.
`quant` ("wint8", "a8w8", "a8w4" or "wint4") quantizes the language model
in place after the build.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...core.init import build_random
from ...ops.attention import use_flash
from ..layers import n_layer_norms
from ..llama.modeling import LlamaAttention, MXUDense, RMSNorm
from .modeling import LlavaConfig, LlavaForConditionalGeneration

LLAVA_7B_VISION = dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                       num_attention_heads=16, image_size=336, patch_size=14,
                       projection_dim=768)
LLAVA_7B_TEXT = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                     num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                     max_position_embeddings=4096)
BENCH_TEXT_LEN = 32   # text ids after the image placeholders (bench.py)
BENCH_NEW_TOKENS = 128


def llava7b_config() -> LlavaConfig:
    return LlavaConfig(vision_config=LLAVA_7B_VISION, text_config=LLAVA_7B_TEXT)


def random_llava(device="cuda", dtype=torch.bfloat16, seed: int = 0, quant=None,
                 config: LlavaConfig = None) -> LlavaForConditionalGeneration:
    """LLaVA (by default 1.5-7B) with weights drawn on `device` from one seeded
    generator; RMSNorm scales stay fp32. `quant` (one of the Llama config's
    `QUANT_MODES`) then quantizes the language model's projections and
    lm_head in place, each bf16 weight freed as its replacement is made."""
    cfg = config or llava7b_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_random(lambda: LlavaForConditionalGeneration(cfg), device=device, dtype=dtype,
                         generator=gen, fp32_modules=(RMSNorm,))
    if quant is not None:
        model.quantize_(quant)
    return model


def bench_input_ids(config: LlavaConfig, text_len: int = BENCH_TEXT_LEN, device="cuda"):
    """The bench's prompt: id 5 everywhere, the image placeholders from
    position 1 on; (1, num_image_tokens + text_len) int64."""
    n_img = config.num_image_tokens
    ids = torch.full((1, n_img + text_len), 5, dtype=torch.long, device=device)
    ids[:, 1:1 + n_img] = config.image_token_index
    return ids


def expected_launches_llava(model: LlavaForConditionalGeneration, prompt_len: int,
                            new_tokens: int) -> Dict[str, int]:
    """Kernel launches of one batch-1 `generate` call, from walking the
    modules: the prefill and each of the new_tokens - 1 decode steps run
    every RMSNorm once (B11) and every quantized projection once: B6 under
    wint8, N1 under a8w8, N2 under a8w4 and wint4 (at M > 1, the prefill, a
    call's activation pass and GEMM count once); every decode step runs
    decode attention once per layer (B7), and so does a one-token prefill.
    The vision tower runs once: its attention goes to flash or math by
    `use_flash` at its token count, and each of its LayerNorms (B10)
    launches once."""
    lm = model.language_model
    forwards = new_tokens  # one prefill + (new_tokens - 1) decode steps
    single_token_forwards = new_tokens - 1 + (prompt_len == 1)
    vcfg = model.config.vision
    tokens = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    q = (1, tokens, vcfg.num_attention_heads, vcfg.hidden_size // vcfg.num_attention_heads)
    count = lambda kind: sum(isinstance(m, kind) for m in lm.modules())  # noqa: E731
    quantized = lambda *modes: forwards * sum(  # noqa: E731
        isinstance(m, MXUDense) and m.quant in modes for m in lm.modules())
    return {
        "rms_norm": count(RMSNorm) * forwards,
        "wint8_matmul": quantized("wint8"),
        "a8w8_matmul": quantized("a8w8"),
        "a8w4_matmul": quantized("a8w4", "wint4"),
        "decode_attention": count(LlamaAttention) * single_token_forwards,
        "flash_attention": vcfg.num_hidden_layers * use_flash(q, q),
        "layer_norm": n_layer_norms(model.vision_tower),
    }
