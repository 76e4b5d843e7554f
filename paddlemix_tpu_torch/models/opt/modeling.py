"""OPT decoder, BLIP-2's frozen language model (port of
paddlemix_tpu/models/opt/modeling.py: OPTAttention, OPTDecoderLayer,
OPTModule, OPTForCausalLM), over the Llama's dense `KVCache` and served by
its `greedy_generate`, whose call surface (`forward(input_ids, positions, *,
inputs_embeds, cache)`, `init_cache`, `config`, `device`) it has, as the JAX
package's `_OPTView` gives it to the JAX `greedy_generate`.

Pre-LN layers (eps `OPT_LAYER_NORM_EPS`, the JAX package's), a relu FFN,
learned positions offset by 2 and clamped at 0, the final LayerNorm, and
logits through the tied token embedding (a plain GEMM). Kernels, each
launched for CUDA tensors (plain versions on the CPU): every LayerNorm runs
on B10 (`ops.norms.layer_norm`, through `FusedLayerNorm`), where the JAX
package keeps flax's; every single-token step attends over the cache through
B7 (`ops.decode_attention.decode_attention`), JAX's `attention_xla` with a
-1e9 bias over the cache being B7's function (a masked slot weighs
exp(-1e9 - m) = 0). The prefill over a cache attends by math over the keys up
to the last position alone (`cache_masks`); the JAX package attends over
every slot but the last, masking by the bias alone, so its sums depend on
the spare slots (ROADMAP, faults of the reference). Without a cache,
attention is causal (`scaled_dot_product_attention`, with segment ids).

Module names follow HF transformers below its `model.decoder.` prefix
(decoder.layers.N.self_attn.q_proj, self_attn_layer_norm, fc1, fc2,
final_layer_norm, decoder.embed_tokens, embed_positions), which the JAX
package's key map renames (`core.convert.OPT_KEY_MAP`, which strips either
prefix). `compute_dtype` (flax's module `dtype`) casts
the embeddings, and each Linear its input and weight, where it is set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.convert import OPT_KEY_MAP
from ...ops.attention import SegmentIds, scaled_dot_product_attention
from ..layers import FusedLayerNorm, Linear, set_compute_dtype
from ..llama.modeling import KVCache, cache_masks, dense_cache_attention, parking_write_idx
from .configuration import OPT_LAYER_NORM_EPS, OPTConfig


class _Step(NamedTuple):
    """What every layer of one forward shares: without a cache the segment
    ids; with one, where to write and the decode lengths or the prefill bias."""

    segment_ids: Optional[SegmentIds] = None
    write_idx: Optional[torch.Tensor] = None  # (B, S) cache slot of each position
    lengths: Optional[torch.Tensor] = None    # (B,) int32, single-token steps
    bias: Optional[torch.Tensor] = None       # (B, 1, S, keys) fp32, prefill


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim_
        self.q_proj = Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, step: _Step, cache: Optional[KVCache], layer_idx: int):
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        if cache is None:
            out = scaled_dot_product_attention(q, k, v, causal=True, segment_ids=step.segment_ids)
        else:
            out = dense_cache_attention(q, k, v, cache.k[layer_idx], cache.v[layer_idx],
                                        step.write_idx, step.lengths, step.bias)
        return self.out_proj(out.reshape(b, s, -1))


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.self_attn_layer_norm = FusedLayerNorm(cfg.hidden_size, eps=OPT_LAYER_NORM_EPS)
        self.self_attn = OPTAttention(cfg)
        self.final_layer_norm = FusedLayerNorm(cfg.hidden_size, eps=OPT_LAYER_NORM_EPS)
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.hidden_size)
        self.relu = cfg.activation_function == "relu"

    def forward(self, x, step: _Step, cache: Optional[KVCache], layer_idx: int):
        x = x + self.self_attn(self.self_attn_layer_norm(x), step, cache, layer_idx)
        h = self.fc1(self.final_layer_norm(x))
        # else flax's nn.gelu, the tanh form
        h = F.relu(h) if self.relu else F.gelu(h, approximate="tanh")
        return x + self.fc2(h)


class OPTDecoder(nn.Module):
    """Embeddings, the decoder layers (unrolled) and the final LayerNorm: the
    JAX `OPTModule` without its logits."""

    compute_dtype: Optional[torch.dtype] = None  # flax Embed's `dtype`

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        # OPT offsets positions by 2 (a padding index of the upstream model)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + 2, cfg.hidden_size)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = FusedLayerNorm(cfg.hidden_size, eps=OPT_LAYER_NORM_EPS)

    def embed(self, input_ids):
        x = self.embed_tokens(input_ids)
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def forward(self, input_ids=None, positions=None, *, inputs_embeds=None, segment_ids=None,
                cache: Optional[KVCache] = None):
        """The final hidden states. Positions -1 mark padding: their
        embedding is position 0's, and over a cache their writes go to the
        parking slot. With a cache, this step's keys and values are written
        into it and its lengths advance by the valid tokens."""
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        x = x + self.embed_positions(positions.clamp(min=0) + 2).to(x.dtype)
        if cache is None:
            step = _Step(segment_ids=segment_ids)
        else:
            slots = cache.k.shape[2]
            step = _Step(None, parking_write_idx(positions, slots),
                         *cache_masks(positions, slots - 1))
        for i, layer in enumerate(self.layers):
            x = layer(x, step, cache, i)
        if cache is not None:
            cache.lengths += (positions >= 0).sum(dim=-1).int()
        return self.final_layer_norm(x)


class OPTForCausalLM(nn.Module):
    """OPT with tied logits (port of `OPTForCausalLM`). `dtype` is the
    compute dtype (None: the parameters')."""

    flax_key_map = OPT_KEY_MAP  # its names -> the JAX OPTModule's

    def __init__(self, config: OPTConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.decoder = OPTDecoder(config)
        set_compute_dtype(self, dtype)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: Optional[torch.dtype] = None):
        """The model of directory `path` (config.json and flax- or HF-keyed
        weights; HF's `lm_head`, the tied table, is dropped) on `device`."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, OPTConfig, OPT_KEY_MAP, path, device=device, dtype=dtype,
                               unused=(r"^lm_head\.",))

    @property
    def device(self):
        return self.decoder.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.decoder.compute_dtype or self.decoder.embed_tokens.weight.dtype

    def embed(self, input_ids):
        return self.decoder.embed(input_ids)

    def forward(self, input_ids=None, positions=None, *, inputs_embeds=None, segment_ids=None,
                cache: Optional[KVCache] = None):
        """-> (logits (B, S, vocab), cache); see `OPTDecoder.forward`."""
        hidden = self.decoder(input_ids, positions, inputs_embeds=inputs_embeds,
                              segment_ids=segment_ids, cache=cache)
        return F.linear(hidden, self.decoder.embed_tokens.weight.to(hidden.dtype)), cache

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The dense cache, in `dtype` (the model's compute dtype by default)."""
        return KVCache.create(self.config, batch, max_len, dtype=dtype or self.dtype,
                              device=self.device)
