"""Llama decoder, with a KV cache for generation and without one for
training, and greedy / sampled generation. Port of
paddlemix_tpu/models/llama/modeling.py: prefill and single-token decode over
the dense `KVCache`, the int8 `Int8KVCache` (`cachekv_int8`) and the
`PagedKVCache` (models/llama/paged.py); the cache-free forward over packed
rows (positions restart in each sample, segment ids keep the samples apart)
with optional per-layer recompute (`gradient_checkpointing`); `MXUDense`
with quant None, "wint8", "a8w8", "a8w4" or "wint4" (config.quant, or
`LlamaForCausalLM.quantize_`), `LlamaForCausalLM` and `greedy_generate`.

Kernels on these paths, each launched for CUDA tensors (plain versions on the
CPU): RMSNorm (B11, `ops.norms.rms_norm`) for every norm; for every
single-token step decode attention over the dense cache (B7,
`ops.decode_attention.decode_attention`), over the int8 cache (B8,
`decode_attention_int8`) or over the paged pool (B9,
`ops.paged_attention.paged_decode_attention`); in the cache-free forward
causal flash attention with segment ids (B1, or under autograd its lse form
B15 and the backward B14, `ops.attention.flash_attention`), and under
autograd RMSNorm's backward (B11); and for every projection and the lm_head
under wint8 the weight-only int8 GEMM (B6, `ops.quant.wint8_matmul`), under
a8w8 the dynamic a8w8 GEMM (N1, `ops.quant.a8w8_matmul`), under a8w4 and
wint4 the a8w4 GEMM over packed int4 weights (N2, `ops.quant.a8w4_matmul`).
N1 and N2 replace no Pallas kernel (JAX runs XLA dots there); each quantizes
x per row at run time. The JAX generate unpacks the int4 tree once before
its decode loop, a TPU workaround; the port's kernel reads the packed
bytes. The JAX package routes these by v5e thresholds (at least 64
rows, at least 2048 cache slots, 128-aligned widths); eager PyTorch has no
fusion to lose, so the port launches them for every call. The prefill
attends over the cache by math attention with a -1e9 bias past each query's
position, as the JAX package does: over the int8 cache dequantized to the
model's dtype (so the fresh keys too carry their int8 rounding), over the
paged pool's dense gather.

The caches are updated in place (JAX returns new ones). Parameter names
follow HF transformers (model.layers.N.self_attn.q_proj, ...), which the JAX
key map renames (core.convert.LLAMA_KEY_MAP). Not ported yet: fused qkv,
scanned layers, beam search, NTK / logn rope, sequence parallelism (ring
attention), and the int8 and paged caches under LLaVA (whose JAX model always
builds the dense cache).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...core.convert import LLAMA_KEY_MAP
from ...ops.attention import SegmentIds, attention_math, scaled_dot_product_attention
from ...ops.decode_attention import decode_attention, decode_attention_int8
from ...ops.norms import rms_norm
from ...ops.paged_attention import paged_decode_attention
from ...ops.quant import (
    a8w4_matmul,
    a8w8_matmul,
    quantize_weights_int4,
    quantize_weights_int8,
    wint8_matmul,
)
from ...ops.rope import apply_rope, rope_cos_sin
from .configuration import QUANT_MODES, LlamaConfig
from .paged import PagedKVCache


@dataclasses.dataclass
class KVCache:
    """k/v: (num_layers, B, slots, kv_heads, head_dim); lengths: (B,) int32
    tokens written per sample. The last slot parks the writes of padded
    positions, so `max_len` = slots - 1. The JAX package rounds the slots to
    128 for its TPU kernel's tiling; the port does not."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, config: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
        shape = (config.num_hidden_layers, batch, max_len + 1, config.kv_heads,
                 config.head_dim_)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2] - 1


@dataclasses.dataclass
class Int8KVCache:
    """The int8 cache (reference deploy --cachekv_int8): k/v (num_layers, B,
    slots, kv_heads, head_dim) int8 with per-(token, head) fp32 scales
    k_scale/v_scale (num_layers, B, slots, kv_heads); lengths as `KVCache`,
    and the same parking slot. Half the bytes a decode step reads from the
    bf16 cache, plus 1/32 for the scales at head_dim 128."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, config: LlamaConfig, batch: int, max_len: int, device="cuda"):
        shape = (config.num_hidden_layers, batch, max_len + 1, config.kv_heads,
                 config.head_dim_)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2] - 1


def _quantize_kv(x):
    """(B, S, H, D) -> int8 values and the per-(token, head) fp32 scale
    max(|x|max / 127, 1e-8); x / scale rounds half to even, as jnp.round.
    The division by 127 is tensor by tensor, so that it divides on the card
    too (PyTorch computes `t / 127.0` there as t * (1 / 127))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-8)
    return torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


class RMSNorm(nn.Module):
    """The scale is kept and used in fp32 whatever the model's dtype, as in
    the JAX package; the output is in x's dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class MXUDense(nn.Linear):
    """A Linear with the JAX `MXUDense`'s quantized modes (`QUANT_MODES`). The
    JAX module pads the rows to 8 for the TPU's matrix unit; the port does
    not. Built with `quant` set, it holds buffers `kernel_q` and `scale` in
    place of its weight, as the JAX module declares them (so a quantized JAX
    tree carries across); `quantize_(mode)` makes them from the weight in
    place and frees it. `kernel_q` is (out, in) int8 under wint8 and a8w8,
    (out, in // 2) packed int4 under a8w4 and wint4; `scale` is (out,) fp32 and
    must stay so. The forwards: wint8 the weight-only int8 GEMM (B6), a8w8 the
    dynamic a8w8 GEMM (N1), a8w4 and wint4 the a8w4 GEMM (N2; JAX's wint4 is
    not weight-only either: it takes the a8w4 branch)."""

    quant: Optional[str] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: Optional[str] = None):
        if quant is None:
            super().__init__(in_features, out_features, bias=bias)
            return
        super().__init__(in_features, out_features, bias=False, device="meta")
        del self.weight
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        width = in_features // 2 if quant in ("a8w4", "wint4") else in_features
        self._hold(quant, torch.zeros((out_features, width), dtype=torch.int8),
                   torch.ones(out_features))

    def _hold(self, quant, kernel_q, scale):
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("scale", scale)
        self.quant = quant

    def forward(self, x):
        if self.quant is None:
            return F.linear(x, self.weight, self.bias)
        if self.quant == "wint8":
            out = wint8_matmul(x, self.kernel_q, self.scale)
        elif self.quant == "a8w8":
            out = a8w8_matmul(x, self.kernel_q, self.scale)
        else:
            out = a8w4_matmul(x, self.kernel_q, self.scale)
        return out if self.bias is None else out + self.bias.to(out.dtype)

    @torch.no_grad()
    def quantize_(self, mode: str) -> int:
        """Quantize the weight once, in place (one leaf of the JAX
        `quantize_tree_wint8` / `quantize_tree_int4`): the weight is freed as
        its kernel_q and scale are made. Returns the bytes freed."""
        if mode not in QUANT_MODES[1:]:
            raise ValueError(f"quantize_: mode {mode!r} is not one of {QUANT_MODES[1:]}")
        if self.quant is not None:
            if self.quant != mode:
                raise ValueError(f"quantize_({mode!r}): already quantized to {self.quant!r}")
            return 0
        quantize = quantize_weights_int4 if mode in ("a8w4", "wint4") else quantize_weights_int8
        kernel_q, scale = quantize(self.weight)
        freed = self.weight.numel() * self.weight.element_size() - kernel_q.numel() \
            - 4 * scale.numel()
        del self.weight
        self._hold(mode, kernel_q, scale)
        return freed


def parking_write_idx(positions, slots: int):
    """(B, S) cache slot of each position: the position, or for padding
    (position -1) the last slot, which parks the writes and is never read."""
    return torch.where(positions >= 0, positions.clamp(max=slots - 1), slots - 1)


def cache_masks(positions, keys: int):
    """(lengths, bias) of one forward over a cache of `keys` readable slots.
    A single token: its (B,) int32 lengths, position + 1, for the decode
    kernel, and no bias. A prefill: no lengths, and the fp32 bias (B, 1, S, n),
    0 where key j <= the query's position p and -1e9 elsewhere, over the n =
    min(keys, last position + 1) keys up to the last position alone, so that
    its result does not depend on the spare slots a cache holds for later
    tokens (the sums of a longer key axis round in another order)."""
    if positions.shape[1] == 1:
        return (positions[:, 0] + 1).int(), None
    n = min(keys, int(positions.max()) + 1)
    key_pos = torch.arange(n, device=positions.device)
    visible = key_pos[None, None, None, :] <= positions[:, None, :, None]
    return None, torch.where(visible, 0.0, -1e9).float()


def dense_cache_attention(q, k, v, ck, cv, write_idx, lengths, bias):
    """Write this step's k / v (B, S, KVH, D) into one layer's dense cache
    ck / cv (B, slots, KVH, D) at `write_idx`, then attend over it (the
    parking slot never read): B7 (`decode_attention`) for a single token
    (`lengths`), else math attention with the prefill's `bias` over the keys
    it spans (`cache_masks`)."""
    bidx = torch.arange(q.shape[0], device=q.device)[:, None]
    ck[bidx, write_idx] = k.to(ck.dtype)
    cv[bidx, write_idx] = v.to(cv.dtype)
    ck, cv = ck[:, :-1], cv[:, :-1]
    if lengths is not None:
        return decode_attention(q, ck, cv, lengths)
    n = bias.shape[-1]
    return attention_math(q, ck[:, :n], cv[:, :n], bias=bias)


class _Step(NamedTuple):
    """What every layer of one forward shares: rope, where to write (the
    slots of the dense and int8 caches, the positions the paged cache maps),
    and either the decode lengths (one token) or the prefill bias; without a
    cache, the segment ids of the packed rows."""

    cos: torch.Tensor
    sin: torch.Tensor
    positions: torch.Tensor              # (B, S), -1 = padding
    write_idx: Optional[torch.Tensor] = None    # (B, S) slot of each position (dense, int8)
    lengths: Optional[torch.Tensor] = None      # (B,) int32, single-token steps
    bias: Optional[torch.Tensor] = None         # (B, 1, S, keys) fp32, prefill
    segment_ids: Optional[SegmentIds] = None    # cache-free forward


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.num_heads, self.kv_heads, self.head_dim = (cfg.num_attention_heads, cfg.kv_heads,
                                                        cfg.head_dim_)
        nq, nkv = self.num_heads * self.head_dim, self.kv_heads * self.head_dim
        self.q_proj = MXUDense(cfg.hidden_size, nq, bias=cfg.attention_bias, quant=cfg.quant)
        self.k_proj = MXUDense(cfg.hidden_size, nkv, bias=cfg.attention_bias, quant=cfg.quant)
        self.v_proj = MXUDense(cfg.hidden_size, nkv, bias=cfg.attention_bias, quant=cfg.quant)
        self.o_proj = MXUDense(nq, cfg.hidden_size, bias=False, quant=cfg.quant)

    def forward(self, x, step: _Step, cache, layer_idx: int):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.kv_heads, self.head_dim)
        q, k = apply_rope(q, k, step.cos, step.sin)
        bidx = torch.arange(b, device=x.device)[:, None]
        if cache is None:  # training: causal over the row, samples kept apart by segment
            out = scaled_dot_product_attention(q, k, v, causal=True, segment_ids=step.segment_ids)
        elif isinstance(cache, PagedKVCache):
            cache.update(layer_idx, k, v, step.positions)
            if step.lengths is not None:
                out = paged_decode_attention(q[:, 0], cache.k_pool[layer_idx],
                                             cache.v_pool[layer_idx], cache.block_tables,
                                             step.lengths)[:, None]
            else:
                n = step.bias.shape[-1]  # the keys the prefill attends over
                pk, pv = cache.layer_view(layer_idx)
                out = attention_math(q, pk[:, :n], pv[:, :n], bias=step.bias)
        elif isinstance(cache, Int8KVCache):
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            ck, cv, cks, cvs = (t[layer_idx] for t in (cache.k, cache.v, cache.k_scale,
                                                       cache.v_scale))
            ck[bidx, step.write_idx], cks[bidx, step.write_idx] = kq, ks
            cv[bidx, step.write_idx], cvs[bidx, step.write_idx] = vq, vs
            # the parking slot is never read
            ck, cv, cks, cvs = ck[:, :-1], cv[:, :-1], cks[:, :-1], cvs[:, :-1]
            if step.lengths is not None:
                out = decode_attention_int8(q, ck, cv, cks, cvs, step.lengths)
            else:
                n = step.bias.shape[-1]
                out = attention_math(q, (ck[:, :n].float() * cks[:, :n, ..., None]).to(x.dtype),
                                     (cv[:, :n].float() * cvs[:, :n, ..., None]).to(x.dtype),
                                     bias=step.bias)
        else:
            out = dense_cache_attention(q, k, v, cache.k[layer_idx], cache.v[layer_idx],
                                        step.write_idx, step.lengths, step.bias)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = MXUDense(cfg.hidden_size, cfg.intermediate_size, bias=False,
                                  quant=cfg.quant)
        self.up_proj = MXUDense(cfg.hidden_size, cfg.intermediate_size, bias=False,
                                quant=cfg.quant)
        self.down_proj = MXUDense(cfg.intermediate_size, cfg.hidden_size, bias=False,
                                  quant=cfg.quant)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, step: _Step, cache, layer_idx: int):
        x = x + self.self_attn(self.input_layernorm(x), step, cache, layer_idx)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModule(nn.Module):
    """Embedding, decoder layers (unrolled) and the final norm: the JAX
    `LlamaModule` without its lm_head, which `LlamaForCausalLM` holds (HF
    names: model.*, lm_head)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def forward(self, input_ids=None, positions=None, *, inputs_embeds=None, segment_ids=None,
                cache=None):
        """Returns the final hidden states. With a cache, writes this step's
        keys and values into it (a `KVCache`, `Int8KVCache` or
        `PagedKVCache`), taking the paged cache's blocks once for all layers,
        and advances its lengths by the valid (position >= 0) tokens. Without
        one (training), attention is causal within each row and, given
        `segment_ids` (a `SegmentIds`), within each segment; under
        `config.gradient_checkpointing` and autograd each layer is recomputed
        in the backward (the JAX `nn.remat` per layer)."""
        cfg = self.config
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
        if cache is None:
            step = _Step(cos, sin, positions, segment_ids=segment_ids)
            remat = cfg.gradient_checkpointing and torch.is_grad_enabled()
            for i, layer in enumerate(self.layers):
                if remat:
                    x = torch.utils.checkpoint.checkpoint(layer, x, step, None, i,
                                                          use_reentrant=False)
                else:
                    x = layer(x, step, None, i)
            return self.norm(x)
        if isinstance(cache, PagedKVCache):
            cache.allocate_for(positions)
            keys, write_idx = cache.max_len, None
        else:
            keys, write_idx = cache.k.shape[2] - 1, parking_write_idx(positions, cache.k.shape[2])
        step = _Step(cos, sin, positions, write_idx, *cache_masks(positions, keys))
        for i, layer in enumerate(self.layers):
            x = layer(x, step, cache, i)
        cache.lengths += (positions >= 0).sum(dim=-1).int()
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    flax_key_map = LLAMA_KEY_MAP  # its names -> the JAX LlamaModule's

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.model = LlamaModule(config)
        self.lm_head = None if config.tie_word_embeddings else \
            MXUDense(config.hidden_size, config.vocab_size, bias=False, quant=config.quant)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: torch.dtype = torch.float32):
        """The model of directory `path` (config.json and flax- or HF-keyed
        weights, sharded or not; HF's rotary `inv_freq` buffers dropped) on
        `device`, its parameters in `dtype` but the RMSNorm scales, which stay
        fp32 (the JAX `from_pretrained(dtype=...)`'s cast)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, LlamaConfig, LLAMA_KEY_MAP, path, device=device, build=cls,
                               param_dtype=dtype, fp32_modules=(RMSNorm,),
                               unused=(r".*rotary_emb\.inv_freq$",))

    def save_pretrained(self, directory: str, **kwargs):
        """`core.modeling.save_pretrained`: config.json and flax-keyed
        safetensors (shards above 5 GiB), in the parameters' dtypes."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.embed_tokens.weight.dtype

    def embed(self, input_ids):
        return self.model.embed(input_ids)

    def forward(self, input_ids=None, positions=None, *, inputs_embeds=None, segment_ids=None,
                cache=None):
        """-> (logits (B, S, vocab), cache); see `LlamaModule.forward`."""
        hidden = self.model(input_ids, positions, inputs_embeds=inputs_embeds,
                            segment_ids=segment_ids, cache=cache)
        if self.lm_head is None:
            return F.linear(hidden, self.model.embed_tokens.weight), cache
        return self.lm_head(hidden), cache

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """An `Int8KVCache` under `cachekv_int8`, else a `KVCache` in `dtype`
        (the model's by default)."""
        if self.config.cachekv_int8:
            return Int8KVCache.create(self.config, batch, max_len, device=self.device)
        return KVCache.create(self.config, batch, max_len, dtype=dtype or self.dtype,
                              device=self.device)

    def quantize_(self, mode: str = "a8w8") -> int:
        """In-place quantization of every projection and the lm_head to `mode`
        (one of `QUANT_MODES`: the reference deploy's weight_only_int8 /
        weight_only_int4, or the JAX package's dynamic a8w8 / a8w4; embeddings
        and norms stay), one module at a time, each weight freed as its
        replacement is made, so that peak memory is the model plus one
        weight's temporaries (port of `quantize_` over `quantize_tree_wint8`
        / `quantize_tree_int4`, every Dense at any size). The config becomes
        a copy with `quant` set, as in the JAX package. Returns the bytes
        freed."""
        if mode not in QUANT_MODES[1:]:
            raise ValueError(f"quantize_: mode {mode!r} is not one of {QUANT_MODES[1:]}")
        freed = sum(m.quantize_(mode) for m in list(self.modules()) if isinstance(m, MXUDense))
        self.config = self.model.config = dataclasses.replace(self.config, quant=mode)
        return freed


class SamplingConfig(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = False


def sample_token(logits, cfg: SamplingConfig, generator: Optional[torch.Generator] = None):
    """logits: (B, V) -> (B,) int64. Greedy takes the first maximum, as
    jnp.argmax does. Sampling draws from `generator` (its stream is not
    JAX's): temperature, then top-k, then the smallest set of top
    probabilities whose sum reaches top_p, as the JAX package filters."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = logits.sort(dim=-1).values[:, -cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return torch.multinomial(logits.softmax(dim=-1), 1, generator=generator)[:, 0]


@torch.inference_mode()
def greedy_generate(model: LlamaForCausalLM, input_ids, attention_mask=None,
                    max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                    sampling: SamplingConfig = SamplingConfig(),
                    generator: Optional[torch.Generator] = None, inputs_embeds=None,
                    cache=None):
    """Prefill, then one cached forward per new token (port of
    `greedy_generate`). `model` is a LlamaForCausalLM or any model of its call
    surface (`forward(input_ids, positions, *, inputs_embeds, cache)` -> (logits,
    cache), `init_cache`, `config.eos_token_id`, `device`): BLIP-2's
    OPTForCausalLM, as the JAX package's `_OPTView` hands its OPT to the JAX
    `greedy_generate`. input_ids: (B, S) right-padded, with attention_mask 0
    on padding. Returns (B, max_new_tokens) int32; after every sample has
    made eos the rest stay 0, as in JAX. The JAX package pads prompts to a
    bucket so that one compiled program serves many lengths; eager PyTorch
    needs no bucket. The all-done test reads the device, so it runs only
    when the eos id is >= 0 (the LLaVA bench passes -1: every request makes
    max_new_tokens tokens). `cache`: an empty cache of at least S +
    max_new_tokens slots to fill, `model.init_cache`'s by default."""
    eos = model.config.eos_token_id if eos_token_id is None else eos_token_id
    dev = model.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    mask = (torch.ones((b, s), dtype=torch.int32, device=dev) if attention_mask is None
            else attention_mask.to(dev).int())
    cache = model.init_cache(b, s + max_new_tokens) if cache is None else cache
    positions = torch.where(mask > 0, mask.cumsum(dim=-1) - 1, -1)
    logits, cache = model(input_ids, positions, inputs_embeds=inputs_embeds, cache=cache)
    last = logits[torch.arange(b, device=dev), mask.sum(dim=-1) - 1]
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    tokens[:, 0] = sample_token(last.float(), sampling, generator)
    done = tokens[:, 0] == eos
    for step in range(max_new_tokens - 1):
        if eos >= 0 and bool(done.all()):
            break
        logits, cache = model(tokens[:, step:step + 1], cache.lengths[:, None], cache=cache)
        nxt = sample_token(logits[:, -1].float(), sampling, generator).int()
        tokens[:, step + 1] = torch.where(done, eos, nxt)
        done |= tokens[:, step + 1] == eos
    return tokens
