"""T5 encoder, SD3's third text tower (port of the encoder side of
paddlemix_tpu/models/t5/modeling.py).

Module names follow HF transformers (shared, encoder.block.N.layer.0.
SelfAttention.{q,k,v,o}, ...layer.0.layer_norm, ...layer.1.DenseReluDense.
{wi_0,wi_1,wo}, encoder.final_layer_norm), which `T5_KEY_MAP` (core/convert.py)
renames to the JAX package's flax names. The one embedding table is `shared`.

T5 attention has no 1/sqrt(d) scale and adds a learned relative position
bias, which block 0 computes and every later block reuses; with a bias the
attention takes the math route. The norms are RMSNorm with an fp32 scale
(`ops.norms.rms_norm`, the B11 kernel on the card).

`T5EncoderModel.from_pretrained` reads a directory as the JAX package's
does: its `config.json` (transformers' T5 config: `d_model`, `d_ff`,
`d_kv`, `num_heads`, `feed_forward_proj`; a JAX- or port-written one too)
and its weights, flax-keyed or in transformers' keys (one
`model.safetensors`, or `model-0000i-of-0000n.safetensors` shards with
their index), the decoder's and the LM head's keys dropped and the rest
renamed through `T5_KEY_MAP` as JAX's `convert_foreign_state_dict` does.
`shared.weight` and `encoder.embed_tokens.weight` both map to the one
table; where both are stored, `shared.weight` is the one kept, as in JAX's
read (the later key of the sorted file wins there). The norms stay fp32.
`save_pretrained` writes what the JAX package's writes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import T5_KEY_MAP
from ...ops.attention import scaled_dot_product_attention
from ...ops.norms import rms_norm


@dataclasses.dataclass
class T5Config(BaseConfig):
    """Defaults are T5 v1.1-XXL's encoder (SD3's text_encoder_3). The
    feed-forward is T5 v1.1's gated-gelu (tanh form, `dense_act_fn`
    "gelu_new"); the JAX package's relu and gated-silu variants are not
    ported, and a config naming one raises."""

    model_type = "t5"
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu_new"
    is_gated_act: bool = True
    feed_forward_proj: str = "gated-gelu"

    def __post_init__(self):
        if self.feed_forward_proj != "gated-gelu":
            raise NotImplementedError(f"T5Config: feed_forward_proj {self.feed_forward_proj!r} "
                                      f"is not ported (only 'gated-gelu')")
        # as the JAX config, feed_forward_proj decides the activation
        self.is_gated_act, self.dense_act_fn = True, "gelu_new"


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 buckets (int32) of key - query positions. The log of
    the large distances is taken in fp32 and truncated to int32, as the JAX
    package does."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_if_large)


class T5LayerNorm(nn.Module):
    """RMSNorm without bias; the scale stays fp32 in a bf16 model."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                    cfg.num_heads) if has_relative_bias else None
        # seeded draws (core.init) at transformers' T5 init: no 1/sqrt(d) scale here
        self.q.init_std = (cfg.d_model * cfg.d_kv) ** -0.5
        if has_relative_bias:
            self.relative_attention_bias.init_std = cfg.d_model ** -0.5

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, s, s) bias in the table's dtype."""
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, position_bias=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, cfg.num_heads, cfg.d_kv) for proj in (self.q, self.k, self.v))
        if position_bias is None:  # block 0, the one that owns the table
            position_bias = self.position_bias(s, x.device)
        out = scaled_dot_product_attention(q, k, v, bias=position_bias, scale=1.0)
        return self.o(out.reshape(b, s, -1)), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias=None):
        attn, position_bias = self.SelfAttention(self.layer_norm(x), position_bias)
        return x + attn, position_bias


class T5DenseGatedActDense(nn.Module):
    """gelu_tanh(wi_0 h) * wi_1 h -> wo."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)])

    def forward(self, x, position_bias=None):
        x, position_bias = self.layer[0](x, position_bias)
        return self.layer[1](x), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        position_bias = None  # made by block 0, reused by the others
        for blk in self.block:
            x, position_bias = blk(x, position_bias)
        return self.final_layer_norm(x)


def convert_hf_state_dict(flat):
    """transformers' T5 keys -> flax keys (JAX's `convert_foreign_state_dict`):
    the decoder's and the LM head's keys dropped, `encoder.embed_tokens.weight`
    dropped where `shared.weight` is stored too (JAX keeps `shared.weight`,
    the later of the two in its sorted read), the rest through `T5_KEY_MAP`.
    The relative position table (buckets, heads) is an embedding: JAX
    transposes it as a Linear's weight and its load transposes it back by
    shape; here it is left as stored."""
    from ...core.modeling import convert_torch_state_dict

    flat = {k: v for k, v in flat.items() if not k.startswith(("decoder.", "lm_head."))}
    if "shared.weight" in flat:
        flat.pop("encoder.embed_tokens.weight", None)
    out = convert_torch_state_dict(flat, T5_KEY_MAP)
    return {k: v.T if k.endswith("relative_attention_bias.embedding") else v
            for k, v in out.items()}


class T5EncoderModel(nn.Module):
    """forward(input_ids (B, S)) -> (last_hidden (B, S, d_model), its mean over S)."""

    flax_key_map = T5_KEY_MAP  # its names -> the JAX T5EncoderModule's

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "T5EncoderModel":
        """The encoder of directory `path` (or its `subfolder`, e.g.
        "text_encoder_3") on `device`, its parameters in `dtype` but the
        norms' scales (fp32)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, T5Config, T5_KEY_MAP, path, device=device, build=cls,
                               param_dtype=dtype, fp32_modules=(T5LayerNorm,),
                               subfolder=subfolder, convert=convert_hf_state_dict)

    def save_pretrained(self, directory: str, **kwargs):
        """config.json and flax-keyed safetensors (shards above 5 GiB), as the
        JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    def forward(self, input_ids):
        x = self.encoder(self.shared(input_ids))
        return x, x.mean(dim=1)
