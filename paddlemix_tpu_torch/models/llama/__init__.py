"""Llama decoder with a dense, int8 or paged KV cache (port of
paddlemix_tpu/models/llama), and the Llama-2-7B serving model."""

from .configuration import LlamaConfig
from .llama7b import (
    expected_launches_eval,
    expected_launches_llama,
    expected_launches_train,
    int8kv_request,
    llama2_7b_config,
    paged_batch,
    random_llama,
)
from .modeling import (
    Int8KVCache,
    KVCache,
    LlamaForCausalLM,
    LlamaModule,
    MXUDense,
    RMSNorm,
    SamplingConfig,
    greedy_generate,
    sample_token,
)
from .paged import PagedKVCache, blocks_needed, paged_greedy_generate

__all__ = ["Int8KVCache", "KVCache", "LlamaConfig", "LlamaForCausalLM", "LlamaModule", "MXUDense",
           "PagedKVCache", "RMSNorm", "SamplingConfig", "blocks_needed",
           "expected_launches_eval", "expected_launches_llama", "expected_launches_train",
           "greedy_generate",
           "int8kv_request", "llama2_7b_config", "paged_batch", "paged_greedy_generate",
           "random_llama", "sample_token"]
