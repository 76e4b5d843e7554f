"""Parameter conversion from the JAX package and seeded initialisation."""

from .convert import (
    CLIP_KEY_MAP,
    EVA_CLIP_KEY_MAP,
    EVA_VISION_KEY_MAP,
    LLAMA_KEY_MAP,
    SD3_KEY_MAP,
    T5_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
    llava_key_to_flax,
    lora_from_flax,
    torch_key_to_flax,
)
from .init import build_random, init_weights_

__all__ = ["CLIP_KEY_MAP", "EVA_CLIP_KEY_MAP", "EVA_VISION_KEY_MAP", "LLAMA_KEY_MAP", "SD3_KEY_MAP", "T5_KEY_MAP", "UNET_KEY_MAP",
           "VAE_KEY_MAP", "build_random", "flatten_flax", "flax_to_torch_state_dict",
           "init_weights_", "llava_key_to_flax", "lora_from_flax", "torch_key_to_flax"]
