"""CLIP ViT-B/16 at the JAX bench's widths, with seeded random weights.

The widths are the JAX package's CLIP bench (bench.py, bench_clip_pairs),
which are examples/train_clip.py's VITB16: a ViT-B/16 tower at 224 px (12
layers, 768 wide, 12 heads, MLP 3072, 197 tokens), a causal text tower (12
layers, 512 wide, 8 heads, MLP 2048, 77 positions, vocab 49408) and
projections to 512. No checkpoint is read: fp32 weights come from a
torch.Generator (core.init), made on the target device, and the model
computes in bf16 over them, as the bench's `CLIPModel(cfg, dtype=bf16)`
does over its fp32 parameters.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.init import build_random
from ..layers import n_layer_norms
from .configuration import CLIPConfig
from .modeling import CLIPModel, scaled_logits

VITB16 = CLIPConfig(
    vision_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                       num_attention_heads=12, image_size=224, patch_size=16),
    text_config=dict(hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                     num_attention_heads=8, max_position_embeddings=77),
    projection_dim=512,
)
BENCH_BATCH = 256


def random_clip(device="cuda", seed: int = 0, config: CLIPConfig = VITB16) -> CLIPModel:
    """A CLIPModel (by default ViT-B/16) with fp32 weights drawn on `device`
    from one seeded generator, computing in bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: CLIPModel(config, dtype=torch.bfloat16), device=device,
                        dtype=torch.float32, generator=gen)


def bench_inputs(config: CLIPConfig, batch: int = BENCH_BATCH, device="cuda"):
    """The bench's inputs: zero pixels (B, S, S, 3) in bf16 and ids all ones
    (B, 77), which hold no eos, so the text tower pools at position 0."""
    size = config.vision.image_size
    return (torch.zeros((batch, size, size, 3), dtype=torch.bfloat16, device=device),
            torch.ones((batch, config.text.max_position_embeddings), dtype=torch.long,
                       device=device))


def seeded_inputs(config: CLIPConfig, batch: int, seed: int, device="cuda"):
    """Normal pixels (B, S, S, 3) in fp32 and ids laid out as a tokenizer
    lays them (start id vocab - 2, 3 to 75 random ids, the eos id, then
    padding 0), from numpy seeded by `seed`: the pooling position varies."""
    rs = np.random.RandomState(seed)
    size, text = config.vision.image_size, config.text
    pixels = rs.standard_normal((batch, size, size, 3)).astype(np.float32)
    ids = np.zeros((batch, text.max_position_embeddings), np.int64)
    ids[:, 0] = text.vocab_size - 2
    for row, n in zip(ids, rs.randint(3, text.max_position_embeddings - 1, batch)):
        row[1:n + 1] = rs.randint(1, text.vocab_size - 2, n)
        row[n + 1] = text.eos_token_id
    return torch.from_numpy(pixels).to(device), torch.from_numpy(ids).to(device)


def pair_logits(model: CLIPModel, pixel_values, input_ids):
    """The function the JAX bench times: scale * img @ txt.T over the
    normalised features, with JAX's promotion (fp32 logits)."""
    img, txt, scale = model(pixel_values, input_ids)
    return scaled_logits(scale, img, txt)


def forward_flops(config: CLIPConfig, batch: int) -> int:
    """The JAX bench's analytic flops of one dual-tower forward: 2 a weight a
    token for each dense (q, k, v, out, fc1, fc2), 4 n^2 d a layer for the
    attention, the patch embedding over every token, the two projections."""
    v, t = config.vision, config.text

    def tower(n, d, dff, layers):
        return layers * (2 * n * d * (4 * d + 2 * dff) + 2 * 2 * n * n * d)

    n_tok = (v.image_size // v.patch_size) ** 2 + 1
    return batch * (
        tower(n_tok, v.hidden_size, v.intermediate_size, v.num_hidden_layers)
        + 2 * n_tok * (3 * v.patch_size ** 2) * v.hidden_size
        + tower(t.max_position_embeddings, t.hidden_size, t.intermediate_size,
                t.num_hidden_layers)
        + 2 * (v.hidden_size + t.hidden_size) * config.projection_dim)


def expected_launches_clip(model: CLIPModel, forwards: int = 1,
                           backwards: int = 0) -> Dict[str, int]:
    """B10 launches of `forwards` dual-tower forwards and `backwards`
    backwards through them, from walking the modules: every FusedLayerNorm
    (2 a layer, the vision tower's pre- and post-LN, the text tower's final
    LN: 51 at ViT-B/16) runs once a forward, and every one has a backward,
    since all parameters train. Attention at 197 and 77 tokens is math
    (`use_flash`), so no other kernel runs."""
    n = n_layer_norms(model)
    return {"layer_norm": n * forwards, "layer_norm_backward": n * backwards}
