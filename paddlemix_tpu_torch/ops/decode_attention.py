"""Decode attention: one query token over a static (B, L, KVH, D) KV cache,
masked by per-sample lengths. Port of paddlemix_tpu/ops/decode_attention.py.

`decode_attention` (bf16 cache, B7) and `decode_attention_int8` (int8 cache
with per-(token, head) fp32 scales, B8) launch the CUDA kernels of
`csrc/decode_attention.cu` for CUDA tensors and run their plain versions
`decode_attention_ref` / `decode_attention_int8_ref` for CPU tensors. GQA maps
query head j to kv head j // (Hq / KVH), as the JAX package does. B7 takes
head_dim 64, 80 (OPT-2.7B's, BLIP-2's language model) and 128, and groups of
1, 2, 4, 7 (Qwen2-7B's 28 heads on 4, Qwen2-VL's language model) and 8; B8
64 and 128, and groups of 1, 2, 4 and 8.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .autograd import refuse_grad

NEG = -0.7 * float(torch.finfo(torch.float32).max)
_KERNEL_HEAD_DIMS = (64, 80, 128)  # B7, the bf16 cache
_INT8_KERNEL_HEAD_DIMS = (64, 128)  # B8
_KERNEL_GROUPS = (1, 2, 4, 7, 8)  # B7
_INT8_KERNEL_GROUPS = (1, 2, 4, 8)  # B8
_SMS = 132               # an H100 SXM's streaming multiprocessors
_MIN_SPLIT_KEYS = 16     # fewer keys per block would not pay for its partial
# blocks of 2 warps an SM a wave: 8 warps an SM, the best point at every
# serving shape in tools/probe_torch_int8_attn_parts.py's sweep of warps a
# block and key ranges (an H100)
WAVE_BLOCKS_PER_SM = 4


def kernel_blocks_per_sm(d: int, group: int, int8: bool) -> int:
    """What the card reports for the kernel at (D, G, cache type):
    cudaOccupancyMaxActiveBlocksPerMultiprocessor after the kernel's
    shared-memory carveout (negative if the query failed or no kernel takes
    the shape: D 80 and G 7 are the bf16 cache's alone)."""
    from ..kernels import load_library

    fn = load_library("decode_attention").decode_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(d, group, int(int8))


def key_splits(batch: int, kv_heads: int, slots: int, sms: int = _SMS):
    """(splits, keys per split) for the kernel's grid of (kv head, batch, key
    range) blocks: whole waves of the card (a multiple of `sms` blocks, as many
    multiples as one wave of WAVE_BLOCKS_PER_SM an SM holds, at least one),
    each range at least _MIN_SPLIT_KEYS keys. Where no multiple of `sms` is
    that long, the most splits up to one wave. The head width does not enter:
    a block is two warps at every D."""
    heads = batch * kv_heads
    wave = sms * WAVE_BLOCKS_PER_SM
    most = max(1, slots // _MIN_SPLIT_KEYS)
    unit = sms // math.gcd(heads, sms)  # the least splits of whole SM multiples
    if unit <= most:
        splits = unit * min(max(1, wave // (heads * unit)), most // unit)
    else:
        splits = max(1, min(-(-wave // heads), most))
    return splits, -(-slots // splits)


def decode_attention_ref(q, k_cache, v_cache, lengths, *, scale: Optional[float] = None):
    """Plain version (port of `decode_attention_xla`): fp32 logits x scale,
    positions at or past the length masked to NEG, fp32 softmax, P in v's
    dtype for the PV product. q: (B, 1, Hq, D); k/v_cache: (B, L, KVH, D);
    lengths: (B,) valid tokens. Returns (B, 1, Hq, D)."""
    hq, d = q.shape[2], q.shape[3]
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5 if scale is None else scale
    if kvh != hq:
        k_cache = k_cache.repeat_interleave(hq // kvh, dim=2)
        v_cache = v_cache.repeat_interleave(hq // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    mask = torch.arange(L, device=q.device)[None, None, None, :] < lengths[:, None, None, None]
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype), v_cache).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _decode_fn():
    from ..kernels import load_library

    fn = load_library("decode_attention").decode_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _decode_int8_fn():
    from ..kernels import load_library

    fn = load_library("decode_attention").decode_attention_int8
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_decode_args(name, q, k_cache, v_cache, lengths, cache_dtype):
    """The shapes, types and layouts the kernels take; returns (B, L, KVH, Hq, D)."""
    b, one, hq, d = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or tuple(k_cache.shape) != (b, L, kvh, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)} do not match")
    int8 = cache_dtype == torch.int8
    dims = _INT8_KERNEL_HEAD_DIMS if int8 else _KERNEL_HEAD_DIMS
    groups = _INT8_KERNEL_GROUPS if int8 else _KERNEL_GROUPS
    if d not in dims or hq % kvh or hq // kvh not in groups:
        raise ValueError(f"{name} kernel takes head_dim in {dims} and "
                         f"Hq / KVH in {groups}, got D = {d}, Hq = {hq}, KVH = {kvh}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be a contiguous bf16 tensor, got {q.dtype} "
                         f"strides {q.stride()}")
    for arg, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        # up to 16 bytes of a row a lane: 16-byte aligned loads
        if t.device != q.device or t.dtype != cache_dtype or t.stride(-1) != 1 \
                or any(s * t.element_size() % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be {cache_dtype} on {q.device} with unit "
                             f"stride over D and 16-byte aligned rows, got {t.dtype} on "
                             f"{t.device}, strides {t.stride()}")
    if lengths.device != q.device or lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths must be ({b},) int32 on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
    return b, L, kvh, hq, d


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_buffers(q, b, kvh, hq, d, L):
    """The output, the key ranges, and the merge's scratch: per (query head,
    key range) the range's max, sum and unnormalised output."""
    splits, chunk = key_splits(b, kvh, L, _sm_count(q.device))
    partial = torch.empty((b, hq, splits, d + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    return torch.empty_like(q), splits, chunk, partial


def _decode_cuda(q, k_cache, v_cache, lengths, scale):
    b, L, kvh, hq, d = _check_decode_args("decode_attention", q, k_cache, v_cache, lengths,
                                          torch.bfloat16)
    lengths = lengths.contiguous()
    out, splits, chunk, partial = _split_buffers(q, b, kvh, hq, d, L)
    partial_ptr = 0 if partial is None else partial.data_ptr()
    with torch.cuda.device(q.device):
        err = _decode_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                           lengths.data_ptr(), out.data_ptr(), partial_ptr, b, L, kvh, hq // kvh,
                           d, splits, chunk, *k_cache.stride()[:3], *v_cache.stride()[:3],
                           float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_bf16 launch failed with cudaError {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, *, scale: Optional[float] = None):
    """Single-token attention over the cache (port of `decode_attention`).
    q: (B, 1, Hq, D); k/v_cache: (B, L, KVH, D), any strides with unit stride
    over D; lengths: (B,) int32 tokens valid, the current one already
    written. CUDA tensors launch the kernel; CPU tensors run
    `decode_attention_ref`."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.is_cuda:
        refuse_grad("decode_attention", q, k_cache, v_cache)
        return _decode_cuda(q, k_cache, v_cache, lengths, scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


decode_attention.launches = 0  # kernel launches (CUDA tensors only)


def decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale, lengths, *,
                              scale: Optional[float] = None):
    """Plain version of B8 (port of what `_decode_kernel_int8` computes): the
    int8 cache dequantized in fp32 (value x its (token, head) scale), fp32
    logits from q x scale, positions at or past the length masked to NEG, fp32
    softmax, P kept in fp32 for the PV product, and zeros for a length of 0.
    q: (B, 1, Hq, D); k_q/v_q: (B, L, KVH, D) int8; k_scale/v_scale: (B, L,
    KVH) fp32; lengths: (B,). Returns (B, 1, Hq, D) in q's dtype."""
    hq, d = q.shape[2], q.shape[3]
    L, kvh = k_q.shape[1], k_q.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k = k_q.float() * k_scale.float()[..., None]
    v = v_q.float() * v_scale.float()[..., None]
    if kvh != hq:
        k = k.repeat_interleave(hq // kvh, dim=2)
        v = v.repeat_interleave(hq // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k)
    mask = torch.arange(L, device=q.device)[None, None, None, :] < lengths[:, None, None, None]
    # masked p are 0 after the softmax, but for a length of 0, whose l the
    # kernel reads as 1: zeros out
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1) * mask
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, lengths, *, scale: Optional[float] = None,
                               k_scale=None, v_scale=None, splits: Optional[int] = None):
    """B7 (bf16 cache) or, with k_scale / v_scale, B8 walked as the kernel
    walks it: the keys cut into `key_splits`' ranges (or `splits` equal ones),
    each range's unnormalised (m, l, acc) over its keys below the length
    (B8: logits (q * scale . k8) * ks and P V as (p * vs) . v8, fp32; B7: P
    rounded to v's dtype for P V, l over fp32 p), then the merge: acc and l
    rescaled by exp(m_s - max m), out = acc / l with l == 0 read as 1. For
    the tests."""
    b, _, hq, d = q.shape
    L, kvh = k_cache.shape[1], k_cache.shape[2]
    g = hq // kvh
    scale = d ** -0.5 if scale is None else scale
    int8 = k_scale is not None
    splits, chunk = key_splits(b, kvh, L) if splits is None else (splits, -(-L // splits))
    qf = (q.float() * scale).reshape(b, kvh, g, d)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    parts = []
    for lo in range(0, splits * chunk, chunk):
        hi = min(lo + chunk, L)
        valid = (torch.arange(lo, max(lo, hi), device=q.device)[None]
                 < lengths.to(q.device)[:, None])[:, None, None, :]  # (B, 1, 1, n)
        s = torch.einsum("bhgd,bnhd->bhgn", qf, k_cache[:, lo:hi].float())
        if int8:
            s = s * k_scale[:, lo:hi].float().transpose(1, 2)[:, :, None, :]
        s = torch.where(valid, s, neg_inf)
        m = s.amax(-1) if s.shape[-1] else torch.full(s.shape[:-1], float("-inf"),
                                                       device=q.device)
        p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])  # 0 where masked
        pv = p * v_scale[:, lo:hi].float().transpose(1, 2)[:, :, None, :] if int8 \
            else p.to(v_cache.dtype).float()
        parts.append((m, p.sum(-1), torch.einsum("bhgn,bnhd->bhgd", pv,
                                                 v_cache[:, lo:hi].float())))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    base = torch.where(top == float("-inf"), 0.0, top)
    l = sum(torch.exp(m - base) * l_s for m, l_s, _ in parts)
    acc = sum(torch.exp(m - base)[..., None] * a for m, _, a in parts)
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _decode_int8_cuda(q, k_q, v_q, k_scale, v_scale, lengths, scale):
    b, L, kvh, hq, d = _check_decode_args("decode_attention_int8", q, k_q, v_q, lengths,
                                          torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (b, L, kvh):
            raise ValueError(f"decode_attention_int8: {name} must be ({b}, {L}, {kvh}) float32 "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lengths = lengths.contiguous()
    out, splits, chunk, partial = _split_buffers(q, b, kvh, hq, d, L)
    partial_ptr = 0 if partial is None else partial.data_ptr()
    with torch.cuda.device(q.device):
        err = _decode_int8_fn()(q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
                                k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
                                out.data_ptr(), partial_ptr, b, L, kvh, hq // kvh, d, splits,
                                chunk, *k_q.stride()[:3], *v_q.stride()[:3],
                                *k_scale.stride(), *v_scale.stride(), float(scale),
                                torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_int8 launch failed with cudaError {err}")
    decode_attention_int8.launches += 1
    return out


def decode_attention_int8(q, k_q, v_q, k_scale, v_scale, lengths, *,
                          scale: Optional[float] = None):
    """Single-token attention over an int8 cache (port of
    `decode_attention_int8`). q: (B, 1, Hq, D); k_q/v_q: (B, L, KVH, D) int8
    with unit stride over D; k_scale/v_scale: (B, L, KVH) fp32, any strides;
    lengths: (B,) int32 tokens valid, the current one already written. CUDA
    tensors launch the kernel (B8); CPU tensors run
    `decode_attention_int8_ref`."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.is_cuda:
        refuse_grad("decode_attention_int8", q, k_scale, v_scale)
        return _decode_int8_cuda(q, k_q, v_q, k_scale, v_scale, lengths, scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    return decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale, lengths, scale=scale)


decode_attention_int8.launches = 0  # kernel launches (CUDA tensors only)
