"""Qwen2-VL (port of paddlemix_tpu/models/qwen2_vl), and Qwen2-VL-7B at its
published widths."""

from .configuration import Qwen2VLConfig, Qwen2VLVisionConfig, published_config_dict
from .modeling import (
    Qwen2VisionTransformer,
    Qwen2VLForConditionalGeneration,
    VisionBlock,
    convert_hf_state_dict,
    get_rope_index,
    hf_state_dict,
)
from .qwen2vl7b import (
    QWEN2_VL_7B,
    expected_launches_qwen2_vl,
    prompt_ids,
    qwen2vl7b_config,
    random_qwen2_vl,
    save_published,
)

__all__ = ["QWEN2_VL_7B", "Qwen2VLConfig", "Qwen2VLForConditionalGeneration",
           "Qwen2VLVisionConfig", "Qwen2VisionTransformer", "VisionBlock",
           "convert_hf_state_dict", "expected_launches_qwen2_vl", "get_rope_index",
           "hf_state_dict", "prompt_ids", "published_config_dict", "qwen2vl7b_config",
           "random_qwen2_vl", "save_published"]
