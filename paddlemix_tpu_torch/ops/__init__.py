"""Ops with hand-written Hopper kernels and their plain versions."""

from .activations import ACT2FN, get_activation
from .attention import (
    attention_math,
    flash_attention,
    flash_attention_ref,
    flash_attention_with_lse,
    scaled_dot_product_attention,
    use_flash,
)
from .norms import group_norm, group_norm_ref

__all__ = [
    "ACT2FN", "attention_math", "flash_attention", "flash_attention_ref",
    "flash_attention_with_lse", "get_activation", "group_norm", "group_norm_ref",
    "scaled_dot_product_attention", "use_flash",
]
