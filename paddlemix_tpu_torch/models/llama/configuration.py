"""Llama-family decoder config (port of paddlemix_tpu/models/llama/configuration.py,
the fields the LLaVA, Llama serving, Llama training, InternVL2 and Qwen-VL
slices use, QWen's NTK-aware rope and logn attention scaling among them),
config.json round-trippable: a JAX- or HF-written config.json loads with its
other keys kept in `unused_kwargs`, but the JAX options this port leaves out
must hold their defaults."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ...core.config import BaseConfig

# the JAX config's options this port leaves out, at their (off) defaults
_UNPORTED = dict(fused_qkv=False, scan_layers=False)
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
    # QWen-v1's long-context options (Qwen-VL's language model). NTK-aware
    # rope: the rope base becomes rope_theta * alpha^(hd / (hd - 2)) for a
    # static alpha (`ntk_alpha_for` gives QWen's dynamic alpha of a context
    # length). logn attention: q at 1-based position i is scaled by
    # max(log(i) / log(logn_seq_length), 1) after rope, in every forward.
    rope_ntk_alpha: float = 1.0
    use_logn_attn: bool = False
    logn_seq_length: int = 2048

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

    def ntk_alpha_for(self, context_length: int) -> float:
        """QWen's dynamic-NTK alpha for a (static) context length:
        2^ceil(log2(context / logn_seq_length) + 1) - 1, at least 1."""
        ratio = max(context_length / self.logn_seq_length, 1.0)
        return max(2 ** math.ceil(math.log2(ratio) + 1) - 1, 1.0)

    @property
    def rope_base(self) -> float:
        """The rope base the layers take: rope_theta, NTK-scaled where
        rope_ntk_alpha is not 1."""
        alpha, hd = self.rope_ntk_alpha, self.head_dim_
        if alpha and alpha != 1.0:
            return self.rope_theta * alpha ** (hd / (hd - 2))
        return self.rope_theta

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads
