"""Llama-2-7B serving and LoRA training, with seeded random weights: the
model, its two serving batches, the kernel launches a request makes and
those a training micro-batch makes.

The widths are the JAX `LlamaConfig` defaults, which are Llama-2-7B's
published ones (meta-llama/Llama-2-7b-hf config.json): 32 layers, 4096 wide,
32 heads x 128, MLP 11008, vocab 32000, 4096 positions. No checkpoint is
read: weights come from a torch.Generator (core.init), made on the target
device. The batches:
- int8 KV cache, long context: one request of 3,968 prompt tokens and 128
  new ones, which fills the 4,096 positions;
- paged KV cache, a mixed batch: 8 right-padded prompts of 2,000 down to 130
  tokens, 128 new tokens each, blocks of 128 keys.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ...core.init import build_random
from .configuration import LlamaConfig
from ...ops.attention import use_flash
from .modeling import LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM, MXUDense, RMSNorm

INT8KV_PROMPT_LEN = 3968
INT8KV_NEW_TOKENS = 128
PAGED_PROMPT_LENS = (2000, 1536, 1200, 900, 640, 400, 256, 130)
PAGED_NEW_TOKENS = 128
PAGED_BLOCK_SIZE = 128


def llama2_7b_config(**overrides) -> LlamaConfig:
    """The JAX LlamaConfig defaults (Llama-2-7B)."""
    return LlamaConfig(**overrides)


def random_llama(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                 cachekv_int8: bool = False) -> LlamaForCausalLM:
    """Llama-2-7B with weights drawn on `device` from one seeded generator;
    RMSNorm scales stay fp32. With `cachekv_int8` its `init_cache` builds the
    int8 cache."""
    cfg = llama2_7b_config(cachekv_int8=cachekv_int8)
    gen = torch.Generator(device=device).manual_seed(seed)
    return build_random(lambda: LlamaForCausalLM(cfg), device=device, dtype=dtype,
                        generator=gen, fp32_modules=(RMSNorm,))


def _prompts(lengths: Sequence[int], vocab: int, seed: int, device) -> Tuple[torch.Tensor,
                                                                               torch.Tensor]:
    """Right-padded (B, max length) int64 ids drawn from [3, vocab) and the
    attention mask, 0 on padding."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, vocab, (len(lengths), max(lengths)), generator=gen)
    mask = (torch.arange(max(lengths))[None, :] < torch.tensor(lengths)[:, None]).int()
    return (ids * mask).to(device), mask.to(device)


def int8kv_request(config: LlamaConfig, seed: int, device="cuda"):
    """(ids, mask) of one int8-KV-cache request: INT8KV_PROMPT_LEN tokens."""
    return _prompts([INT8KV_PROMPT_LEN], config.vocab_size, seed, device)


def paged_batch(config: LlamaConfig, seed: int, device="cuda"):
    """(ids, mask) of the paged cache's mixed batch (PAGED_PROMPT_LENS)."""
    return _prompts(PAGED_PROMPT_LENS, config.vocab_size, seed, device)


def expected_launches_llama(model: LlamaForCausalLM, prompt_lens: Sequence[int],
                            new_tokens: int, cache: str) -> Dict[str, int]:
    """Kernel launches of one `greedy_generate` (cache "dense" or "int8") or
    `paged_greedy_generate` (cache "paged") call over a batch of these prompt
    lengths, with no eos, from walking the modules: the prefill and each of
    the new_tokens - 1 decode steps run every RMSNorm once (B11) and, under
    wint8, every quantized projection once (B6); every decode step runs the
    cache's decode attention once per layer (B7, B8 or B9), and so does a
    prefill of one token."""
    if cache not in ("dense", "int8", "paged"):
        raise ValueError(f"expected_launches_llama: cache {cache!r} is not dense, int8 or paged")
    single_token_forwards = new_tokens - 1 + (max(prompt_lens) == 1)
    count = lambda kind: sum(isinstance(m, kind) for m in model.modules())  # noqa: E731
    attention = {"dense": "decode_attention", "int8": "decode_attention_int8",
                 "paged": "paged_decode_attention"}
    out = {name: 0 for name in attention.values()}
    out[attention[cache]] = count(LlamaAttention) * single_token_forwards
    return dict(out, rms_norm=count(RMSNorm) * new_tokens,
                wint8_matmul=sum(isinstance(m, MXUDense) and m.quant == "wint8"
                                 for m in model.modules()) * new_tokens,
                flash_attention=0)


def expected_launches_eval(model: LlamaForCausalLM, forwards: int,
                           seq_len: int = 2048) -> Dict[str, int]:
    """Kernel launches of `forwards` evaluation forwards (cache-free, under
    `torch.inference_mode`, LoRA factors merged in each projection's forward)
    of `seq_len`-token rows, from walking the modules: every RMSNorm runs its
    forward (B11) and each layer's attention, routed to flash at this shape,
    the inference form of the forward (B1, causal + segment ids); nothing
    of the backward, no cache kernel."""
    cfg = model.config
    count = lambda kind: sum(isinstance(m, kind) for m in model.modules())  # noqa: E731
    shape = (1, seq_len, cfg.num_attention_heads, cfg.head_dim_)
    flash = use_flash(shape, shape[:2] + (cfg.kv_heads, cfg.head_dim_), causal=True)
    return dict(rms_norm=count(RMSNorm) * forwards,
                flash_attention=flash * count(LlamaDecoderLayer) * forwards,
                rms_norm_backward=0, flash_fwd_lse=0, flash_bwd_dkv=0, flash_bwd_dq=0,
                decode_attention=0, decode_attention_int8=0, paged_decode_attention=0,
                wint8_matmul=0)


def expected_launches_train(model: LlamaForCausalLM, micro_batches: int,
                            seq_len: int = 2048) -> Dict[str, int]:
    """Kernel launches of `micro_batches` LoRA training micro-batches
    (cache-free forward and backward, every base weight, embedding and norm
    frozen) of `seq_len`-token rows, from walking the modules: every RMSNorm
    runs its forward (B11) and, but for layer 0's input norm, whose input is
    the frozen embedding and which has nothing to differentiate, its backward;
    each layer's attention, routed to flash at this shape, runs the lse
    forward (B15) and the dkv and dq backward (B14). Under
    `gradient_checkpointing` each layer's forward runs again in the
    backward."""
    cfg = model.config
    count = lambda kind: sum(isinstance(m, kind) for m in model.modules())  # noqa: E731
    layers, norms = count(LlamaDecoderLayer), count(RMSNorm)
    shape = (1, seq_len, cfg.num_attention_heads, cfg.head_dim_)
    flash = use_flash(shape, shape[:2] + (cfg.kv_heads, cfg.head_dim_), causal=True)
    again = 2 if cfg.gradient_checkpointing else 1
    out = dict(rms_norm=norms + (again - 1) * 2 * layers, rms_norm_backward=norms - 1,
               flash_fwd_lse=flash * layers * again, flash_bwd_dkv=flash * layers,
               flash_bwd_dq=flash * layers)
    return dict({k: v * micro_batches for k, v in out.items()}, flash_attention=0,
                decode_attention=0, decode_attention_int8=0, paged_decode_attention=0,
                wint8_matmul=0)
