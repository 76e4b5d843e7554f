"""Paged decode attention: one query token per sequence over a pool of
fixed-size KV blocks, read through each sequence's block table. Port of
paddlemix_tpu/ops/paged_attention.py.

`paged_decode_attention` launches the CUDA kernel of `csrc/paged_attention.cu`
(B9) for CUDA tensors and runs its plain version `paged_decode_attention_ref`
for CPU tensors. The kernel reads only the blocks below ceil(length / bs) of
each sequence, so the JAX wrapper's forward fill of the -1 entries (a way to
skip TPU copies) has no counterpart here. Pool layout (num_blocks, KVH, bs,
D): one (block, head) tile is a contiguous bs x D run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .autograd import refuse_grad
_KERNEL_HEAD_DIMS = (64, 128)  # csrc/paged_attention.cu's (B7's also takes 80)
_KERNEL_GROUPS = (1, 2, 4, 8)  # (B7's also takes 7)
_TARGET_BLOCKS = 264     # two blocks per SM on a 132-SM card
_MIN_SPLIT_KEYS = 64     # fewer keys per block would not pay for the merge


def key_splits(batch: int, kv_heads: int, slots: int):
    """(splits, keys per split) for the kernel: enough (batch, kv head, key
    range) blocks to fill the card, each range at least _MIN_SPLIT_KEYS."""
    splits = max(1, min(-(-_TARGET_BLOCKS // (batch * kv_heads)), slots // _MIN_SPLIT_KEYS))
    return splits, -(-slots // splits)


_MASKED = -1e30


def paged_decode_supported(h: int, kvh: int, hd: int, bs: int) -> bool:
    """Shapes the CUDA kernel takes: head_dim 64 or 128, a block size that is
    a multiple of 16, and H / KVH in {1, 2, 4, 8}."""
    return (hd in _KERNEL_HEAD_DIMS and bs >= 16 and bs % 16 == 0 and h % kvh == 0
            and h // kvh in _KERNEL_GROUPS)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               scale: Optional[float] = None):
    """Plain version (port of what `_paged_decode_kernel` computes): each
    sequence's blocks gathered by its table (-1 read as block 0, masked), q
    and k in fp32, logits times scale after the dot, keys at or past the
    length masked to -1e30 with p forced to 0, P and V in fp32, out = acc /
    max(l, 1e-30). q: (B, H, D); pools: (num_blocks, KVH, bs, D);
    block_tables: (B, nb_max) int32; lengths: (B,). Returns (B, H, D) in q's
    dtype."""
    b, h, d = q.shape
    kvh, bs = k_pool.shape[1], k_pool.shape[2]
    nb_max = block_tables.shape[1]
    scale = d ** -0.5 if scale is None else scale
    tables = block_tables.clamp(min=0).long()
    # (B, nb_max, KVH, bs, D) -> (B, KVH, nb_max * bs, D)
    k = k_pool[tables].transpose(1, 2).reshape(b, kvh, nb_max * bs, d).float()
    v = v_pool[tables].transpose(1, 2).reshape(b, kvh, nb_max * bs, d).float()
    qg = q.float().reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k) * scale
    invalid = torch.arange(nb_max * bs, device=q.device)[None, :] >= lengths[:, None]
    invalid = invalid[:, None, None, :]
    logits = logits.masked_fill(invalid, _MASKED)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)).masked_fill(invalid, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v) / l
    return out.reshape(b, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _paged_fn():
    from ..kernels import load_library

    fn = load_library("paged_attention").paged_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _paged_cuda(q, k_pool, v_pool, block_tables, lengths, scale):
    b, h, d = q.shape
    kvh, bs = k_pool.shape[1], k_pool.shape[2]
    nb_max = block_tables.shape[1]
    if k_pool.dim() != 4 or k_pool.shape[3] != d or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} do not match")
    if not paged_decode_supported(h, kvh, d, bs):
        raise ValueError(f"paged_decode_attention kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"a block size that is a multiple of 16 and H / KVH in "
                         f"{_KERNEL_GROUPS}, got D = {d}, bs = {bs}, H = {h}, KVH = {kvh}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous, 16-byte "
                             f"aligned bf16 tensor on {q.device}, got {t.dtype} on {t.device}")
    for name, t, shape in (("block_tables", block_tables, (b, nb_max)), ("lengths", lengths, (b,))):
        if t.device != q.device or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_attention: {name} must be {shape} int32 on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    splits, chunk_blocks = key_splits(b, kvh, nb_max * bs)
    chunk_blocks = -(-chunk_blocks // bs)  # whole table entries per range
    splits = -(-nb_max // chunk_blocks)
    # per (query head, range of entries): the range's max, sum and unnormalised output
    partial = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    with torch.cuda.device(q.device):
        err = _paged_fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                          block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                          0 if partial is None else partial.data_ptr(), b, kvh, h // kvh, d, bs,
                          nb_max, splits, chunk_blocks, float(scale),
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention_bf16 launch failed with cudaError {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None):
    """Single-token decode attention over a paged KV pool (port of
    `paged_decode_attention`). q: (B, H, D) post-rope queries; k/v_pool:
    (num_blocks, KVH, bs, D); block_tables: (B, nb_max) int32, -1 =
    unassigned; lengths: (B,) int32 valid tokens, the current one included.
    CUDA tensors launch the kernel (raising outside `paged_decode_supported`);
    CPU tensors run `paged_decode_attention_ref`. Returns (B, H, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.is_cuda:
        refuse_grad("paged_decode_attention", q, k_pool, v_pool)
        return _paged_cuda(q, k_pool, v_pool, block_tables, lengths, scale)
    if q.device.type != "cpu":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, scale=scale)


paged_decode_attention.launches = 0  # kernel launches (CUDA tensors only)
