"""InternVL2 (port of paddlemix_tpu/models/internvl2), and InternVL2-8B at
its published widths."""

from .intern_vit import InternAttention, InternVisionConfig, InternVisionModel, interpolate_pos
from .internvl2_8b import (
    INTERNVL2_8B,
    expected_launches_internvl2,
    internvl2_8b_config,
    prompt_ids,
    random_internvl2,
)
from .modeling import InternVLChatConfig, InternVLChatModel, convert_hf_state_dict, pixel_shuffle

__all__ = ["INTERNVL2_8B", "InternAttention", "InternVLChatConfig", "InternVLChatModel",
           "InternVisionConfig", "InternVisionModel", "convert_hf_state_dict",
           "expected_launches_internvl2", "internvl2_8b_config", "interpolate_pos",
           "pixel_shuffle", "prompt_ids", "random_internvl2"]
