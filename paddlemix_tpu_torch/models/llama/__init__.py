"""Llama decoder with a static KV cache (port of paddlemix_tpu/models/llama)."""

from .configuration import LlamaConfig
from .modeling import (
    KVCache,
    LlamaForCausalLM,
    LlamaModule,
    MXUDense,
    RMSNorm,
    SamplingConfig,
    greedy_generate,
    sample_token,
)

__all__ = ["KVCache", "LlamaConfig", "LlamaForCausalLM", "LlamaModule", "MXUDense", "RMSNorm",
           "SamplingConfig", "greedy_generate", "sample_token"]
