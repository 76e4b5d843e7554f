"""OPT decoder config (copy of paddlemix_tpu/models/opt/modeling.py
`OPTConfig`), config.json round-trippable; a foreign (HF) config.json loads
with its other keys kept in `unused_kwargs`."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...core.config import BaseConfig

# The JAX package's OPT LayerNorms are flax's default (eps 1e-6); the upstream
# OPT's are nn.LayerNorm's 1e-5. The port matches the JAX package, its
# reference (ROADMAP, faults of the reference).
OPT_LAYER_NORM_EPS = 1e-6


@dataclasses.dataclass
class OPTConfig(BaseConfig):
    model_type = "opt"
    vocab_size: int = 50272
    hidden_size: int = 2560
    ffn_dim: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None
    do_layer_norm_before: bool = True
    activation_function: str = "relu"
    bos_token_id: int = 2
    eos_token_id: int = 2
    pad_token_id: int = 1

    def __post_init__(self):
        # the JAX module reads neither: its layers are pre-LN and it has no
        # project_in / project_out, so a config that needs them would load
        # into another model there
        if not self.do_layer_norm_before:
            raise NotImplementedError("OPTConfig: only the pre-LN OPT (do_layer_norm_before) "
                                      "is ported")
        if self.word_embed_proj_dim not in (None, self.hidden_size):
            raise NotImplementedError(f"OPTConfig: word_embed_proj_dim "
                                      f"{self.word_embed_proj_dim} != hidden_size "
                                      f"{self.hidden_size} (project_in / project_out) is not "
                                      f"ported")
        if self.activation_function not in ("relu", "gelu"):
            raise NotImplementedError(f"OPTConfig: activation {self.activation_function!r}")

    @property
    def kv_heads(self) -> int:
        """Read by the shared `KVCache`: OPT has no GQA."""
        return self.num_attention_heads

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads
