"""Qwen2-VL-7B (Qwen/Qwen2-VL-7B-Instruct, the model of
configs/qwen2_vl/sft_7b.json) at its published widths, with seeded random
weights.

Widths: the published config.json. The language model is Qwen2-7B: vocab
152,064, 3,584 wide, MLP 18,944, 28 layers, 28 query heads on 4 KV heads
of 128 (GQA group 7), q / k / v biases, RMSNorm eps 1e-6, rope theta 1e6,
M-RoPE sections (16, 24, 24), an untied lm_head. The vision tower: 32
blocks, 1,280 wide, 16 heads of 80, MLP ratio 4, patches of 2 x 14 x 14 x 3
merged 2 x 2 into 3,584-wide features. About 8.29 B parameters. No
checkpoint is read: weights come from a torch.Generator (core.init), made on
the target device, in `dtype` (bf16 by default; the RMSNorm scales and the
LayerNorms' weights and biases in fp32).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

import json
import os

from ...core.init import build_random
from ...core.modeling import save_state_dict
from ...ops.attention import use_flash
from ..layers import FusedLayerNorm, n_layer_norms
from ..llama.modeling import LlamaAttention, RMSNorm
from .configuration import Qwen2VLConfig, published_config_dict
from .modeling import Qwen2VLForConditionalGeneration, hf_state_dict

QWEN2_VL_7B = dict(
    vision_config=dict(depth=32, embed_dim=1280, num_heads=16, in_channels=3, patch_size=14,
                       spatial_merge_size=2, temporal_patch_size=2, mlp_ratio=4.0,
                       hidden_size=3584),
    text_config=dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                     num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
                     max_position_embeddings=32768, rms_norm_eps=1e-6,
                     tie_word_embeddings=False, bos_token_id=151643, eos_token_id=151645),
    image_token_id=151655, video_token_id=151656, vision_start_token_id=151652,
    rope_theta=1000000.0, mrope_section=(16, 24, 24),
)
VISION_END_ID = 151653
TEXT_ID_LIMIT = 151643  # prompt ids are drawn below the special ids (<|endoftext|> on)
PROMPT_TEXT_LEN = 32    # text ids after the vision spans
NEW_TOKENS = 128


def qwen2vl7b_config() -> Qwen2VLConfig:
    return Qwen2VLConfig.from_dict(QWEN2_VL_7B)


def random_qwen2_vl(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                    config: Qwen2VLConfig = None) -> Qwen2VLForConditionalGeneration:
    """Qwen2-VL (by default 7B) with weights drawn on `device` from one seeded
    generator, in `dtype` but for the norms' (fp32)."""
    cfg = config or qwen2vl7b_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: Qwen2VLForConditionalGeneration(cfg), device=device,
                        dtype=dtype, generator=gen, fp32_modules=(RMSNorm, FusedLayerNorm))


def save_published(model: Qwen2VLForConditionalGeneration, directory: str,
                   max_shard_bytes: int = 4 * 10 ** 9) -> Dict[str, int]:
    """`model` in the published checkpoint's layout: config.json as
    `published_config_dict` writes it (no `text_config`) and `hf_state_dict`
    in shards of at most `max_shard_bytes` with their index. Returns {file
    name: bytes}."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(published_config_dict(model.config), f, indent=2)
    return save_state_dict(hf_state_dict(model), directory, max_shard_bytes=max_shard_bytes)


def prompt_ids(config: Qwen2VLConfig, spans: Sequence[tuple], text_len: int = PROMPT_TEXT_LEN,
               seed: int = 0, vision_end_id: int = VISION_END_ID,
               text_id_limit: int = TEXT_ID_LIMIT) -> torch.Tensor:
    """A request's prompt (1, S) int64: for each (kind, placeholders) of
    `spans` (kind "image" or "video"), the vision start id, that many image
    or video pad ids and the vision end id; then `text_len` ids drawn from a
    seeded generator below `text_id_limit` (no tokenizer files are in the
    repository)."""
    ids = []
    for kind, n in spans:
        pad = config.image_token_id if kind == "image" else config.video_token_id
        ids += [config.vision_start_token_id] + [pad] * n + [vision_end_id]
    text = torch.randint(0, text_id_limit, (text_len,), generator=torch.Generator().manual_seed(seed))
    return torch.cat([torch.tensor(ids, dtype=torch.long), text])[None]


def expected_launches_qwen2_vl(model: Qwen2VLForConditionalGeneration, prompt_len: int,
                               new_tokens: int, patch_rows: int = 0) -> Dict[str, int]:
    """Kernel launches of one batch-1 `generate` of `new_tokens` over a prompt
    of `prompt_len` ids with `patch_rows` packed patches (0: text alone),
    from walking the modules: the tower runs once, each of its LayerNorms
    launching B10 once (32 x 2 + the merger's = 65 at 7B), and its attention
    goes to flash (B1) or math by `use_flash` at the patch rows (flash at
    every request of the smoke); the language model runs new_tokens forwards
    (the prefill, then a decode step a token after the first), each
    launching its RMSNorms (28 x 2 + the final = 57), and every
    single-token forward launches B7 once a layer. The prefill over the
    cache runs math attention."""
    lm = model.language_model
    v = model.config.vision
    single_token_forwards = new_tokens - 1 + (prompt_len == 1)
    q = (1, patch_rows, v.num_heads, v.embed_dim // v.num_heads)
    count = lambda kind: sum(isinstance(m, kind) for m in lm.modules())  # noqa: E731
    return {
        "rms_norm": count(RMSNorm) * new_tokens,
        "decode_attention": count(LlamaAttention) * single_token_forwards,
        "layer_norm": n_layer_norms(model.visual) if patch_rows else 0,
        "flash_attention": v.depth * use_flash(q, q) if patch_rows else 0,
    }
