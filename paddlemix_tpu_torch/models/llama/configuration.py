"""Llama-family decoder config (port of paddlemix_tpu/models/llama/configuration.py,
the fields the LLaVA, Llama serving and Llama training slices use),
config.json round-trippable: a JAX- or HF-written config.json loads with its
other keys kept in `unused_kwargs`, but the JAX options this port leaves out
must hold their defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...core.config import BaseConfig

# the JAX config's options this slice leaves out, at their (off) defaults
_UNPORTED = dict(fused_qkv=False, scan_layers=False, rope_ntk_alpha=1.0,
                 use_logn_attn=False, logn_seq_length=2048)
# the Dense layers' quantization (`MXUDense`): weight-only int8, dynamic int8
# activations with int8 or packed int4 weights (wint4 computes as a8w4)
QUANT_MODES = (None, "wint8", "a8w8", "a8w4", "wint4")


@dataclasses.dataclass
class LlamaConfig(BaseConfig):
    model_type = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    hidden_act: str = "silu"
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: Optional[int] = None
    cachekv_int8: bool = False  # init_cache builds an Int8KVCache
    gradient_checkpointing: bool = False  # recompute each layer in the backward (training)
    # one of QUANT_MODES: the projections and the lm_head hold kernel_q / scale
    # in place of their weight (set by LlamaForCausalLM.quantize_, or given to
    # build a model that takes a quantized state dict)
    quant: Optional[str] = None

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"LlamaConfig: quant {self.quant!r} is not one of {QUANT_MODES}")

    @classmethod
    def from_dict(cls, data, **overrides):
        """The JAX config's options that this slice does not port must hold
        their defaults; other keys the class has no field for are kept in
        `unused_kwargs`."""
        data = dict(data, **overrides)
        unported = {k: v for k, v in data.items() if k in _UNPORTED and _UNPORTED[k] != v}
        if unported:
            raise NotImplementedError(f"LlamaConfig: options not ported: {unported}")
        return super().from_dict({k: v for k, v in data.items() if k not in _UNPORTED})

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads
