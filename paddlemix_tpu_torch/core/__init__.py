"""Parameter conversion from the JAX package and seeded initialisation."""

from .convert import (
    BLIP2_KEY_MAP,
    CLIP_KEY_MAP,
    EVA_CLIP_KEY_MAP,
    EVA_VISION_KEY_MAP,
    LLAMA_KEY_MAP,
    LLAVA_KEY_MAP,
    OPT_KEY_MAP,
    QFORMER_KEY_MAP,
    QWEN2_VL_KEY_MAP,
    SD3_KEY_MAP,
    T5_KEY_MAP,
    UNET_KEY_MAP,
    VAE_KEY_MAP,
    blip2_key_to_flax,
    flatten_flax,
    flax_to_torch_state_dict,
    llava_key_to_flax,
    load_flax_state_,
    lora_from_flax,
    lora_to_flax,
    qwen2_vl_key_to_flax,
    torch_key_to_flax,
    torch_to_flax_state_dict,
)
from .init import build_random, init_weights_

__all__ = ["BLIP2_KEY_MAP", "CLIP_KEY_MAP", "EVA_CLIP_KEY_MAP", "EVA_VISION_KEY_MAP",
           "LLAMA_KEY_MAP", "LLAVA_KEY_MAP", "OPT_KEY_MAP", "QFORMER_KEY_MAP", "QWEN2_VL_KEY_MAP", "SD3_KEY_MAP",
           "T5_KEY_MAP", "UNET_KEY_MAP", "VAE_KEY_MAP", "blip2_key_to_flax", "build_random",
           "flatten_flax", "flax_to_torch_state_dict", "init_weights_", "llava_key_to_flax",
           "load_flax_state_", "lora_from_flax", "lora_to_flax", "qwen2_vl_key_to_flax",
           "torch_key_to_flax",
           "torch_to_flax_state_dict"]
