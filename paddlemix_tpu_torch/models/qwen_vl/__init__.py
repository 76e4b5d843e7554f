"""Qwen-VL (v1) (port of paddlemix_tpu/models/qwen_vl), and Qwen-VL-Chat at
its published widths."""

from .modeling import QwenVLConfig, QwenVLForConditionalGeneration, convert_hf_state_dict
from .qwenvl_chat import (
    QWEN_VL_CHAT,
    expected_launches_qwen_vl,
    prompt_ids,
    qwenvl_chat_config,
    random_qwen_vl,
    set_ntk_alpha,
)
from .visual import (
    QwenVisionConfig,
    QwenVisionTransformer,
    Resampler,
    VisualAttentionBlock,
    get_2d_sincos_pos_embed,
    get_abs_pos,
)

__all__ = ["QWEN_VL_CHAT", "QwenVLConfig", "QwenVLForConditionalGeneration", "QwenVisionConfig",
           "QwenVisionTransformer", "Resampler", "VisualAttentionBlock", "convert_hf_state_dict",
           "expected_launches_qwen_vl", "get_2d_sincos_pos_embed", "get_abs_pos",
           "prompt_ids", "qwenvl_chat_config", "random_qwen_vl", "set_ntk_alpha"]
