"""Attention: math reference, the flash-attention forward and backward, and
the shape rule that picks between flash and math. Port of
paddlemix_tpu/ops/attention.py.

Layout: q/k/v are (batch, seq, heads, head_dim), as in the JAX package; k/v
may have fewer heads than q (GQA: query head h reads kv head h // group).

Kernels (CUDA tensors launch them; CPU tensors run their plain versions):
- `csrc/flash_fwd.cu`: the forward (B1), with causal (top-left), segment ids
  and GQA, at head dims up to 256. `flash_attention` launches its inference
  form (no lse, the scale folded in fp32); `flash_attention_int8` the
  inference form with int8 QK^T (`int8_qk`, the JAX switch PMIX_INT8_ATTN=1:
  q and k quantized per row, an exact int32 product, B1's softmax and bf16
  P.V; at head dims 64 and 128 an activation pass, `quantize_qk_int8`,
  quantizes q and k once before the core runs, as the JAX wrapper's
  prologue does); `flash_fwd_lse` its lse form (B15), on q pre-scaled by
  scale * log2(e) and rounded to q's dtype as the JAX wrapper does, writing
  the base-2 lse of each row, fp32 (B, H, S);
- `csrc/flash_bwd.cu`: the backward (B14), `flash_bwd_dkv` and
  `flash_bwd_dq`, from that pre-scaled q, the lse and di = rowsum(o * do),
  at head dims up to 256 (`_BWD_HEAD_DIMS`): heads of 33-64 and 65-128 run
  its wgmma core at 64 and 128 (read in place when a multiple of 8), which
  writes the gradients in bf16 in the caller's layout and skips the tile
  pairs of which no pair is visible; 129-160 and 161-256 are padded to the
  WMMA core's 160 and 256. `flash_bwd_{dkv,dq}_tiled_ref` are the plain
  versions walked tile by tile with that skipping, for the tests and
  chip_smoke.py.
Under autograd, `flash_attention` is `_FlashAttention` (the JAX
`_flash_attention` custom_vjp): forward by `flash_fwd_lse` (bf16 QK^T even
with `int8_qk`, as in JAX), backward by the two B14 kernels. Segment ids compare
as given: the kernels mask by bounds, so nothing is padded, and the JAX
wrapper's +1 shift (which keeps its padding apart) has nothing to do. The
choice between flash and math (`scaled_dot_product_attention`) is made from
shapes alone, the same on both devices (`use_flash`): the JAX package's rule.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .autograd import grad_needed, refuse_grad

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = math.log2(math.e)
# head dims compiled into flash_fwd.cu and flash_bwd.cu: a head runs the least
# at or above it (the backward's 65-128 run its wgmma core's 128)
_KERNEL_HEAD_DIMS = (32, 64, 96, 128, 160, 256)
_BWD_HEAD_DIMS = (32, 64, 128, 160, 256)
# the compiled head dims that csrc/flash_fwd.cu's fixed table (`uses_wgmma`)
# sends to its wgmma core, in both forms (bf16 and int8 QK^T); the others run
# its WMMA core
_FWD_WGMMA_HEAD_DIMS = (64, 128)


def flash_fwd_uses_wgmma(d_kernel: int) -> bool:
    """The forward's core at a compiled head_dim, as csrc/flash_fwd.cu's table
    picks it (`flash_fwd_core` there answers the same): the wgmma core at 64
    and 128, bf16 and int8 QK^T alike, else the WMMA core."""
    return d_kernel in _FWD_WGMMA_HEAD_DIMS


def int8_qk_default() -> bool:
    """The JAX package's switch for int8 QK^T: PMIX_INT8_ATTN=1."""
    return os.environ.get("PMIX_INT8_ATTN", "0") == "1"


class SegmentIds(NamedTuple):
    q: torch.Tensor   # (B, Sq) int
    kv: torch.Tensor  # (B, Skv) int


def _expand_kv(k, v, heads):
    """GQA: repeat each kv head over its group of query heads."""
    if k.shape[2] == heads:
        return k, v
    g = heads // k.shape[2]
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _keep(sq, skv, causal, segment_ids, device, bottom_right=False):
    """(B or 1, 1, Sq, Skv) bool of the visible (query, key) pairs, or None."""
    keep = None
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool, device=device).tril(
            skv - sq if bottom_right else 0)[None, None]
    if segment_ids is not None:
        seg = (segment_ids.q[:, :, None] == segment_ids.kv[:, None, :])[:, None]
        keep = seg if keep is None else keep & seg
    return keep


def attention_math(q, k, v, *, bias=None, causal=False, segment_ids=None,
                   scale: Optional[float] = None):
    """Math attention (port of `attention_xla`): fp32 logits and softmax, P in
    v's dtype for the PV product. q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D); causal
    is bottom-right aligned, as attention_xla's."""
    d = q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    k, v = _expand_kv(k, v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    keep = _keep(q.shape[1], k.shape[1], causal, segment_ids, q.device, bottom_right=True)
    if keep is not None:
        logits = logits.masked_fill(~keep, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


# ------------------------------------------------------------ plain versions
def flash_attention_ref(q, k, v, *, scale: Optional[float] = None, causal=False,
                        segment_ids=None):
    """Plain version of the flash kernel's inference form: the whole
    computation in fp32, the result in q's dtype. q: (B,Sq,H,D), k/v:
    (B,Skv,Hkv,D); causal is top-left aligned, as the kernel's."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    k, v = _expand_kv(k, v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep(q.shape[1], k.shape[1], causal, segment_ids, q.device)
    if keep is not None:
        logits = logits.masked_fill(~keep, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def quantize_rows_int8(x):
    """Per-row symmetric int8 over the last dim, the XLA prologue of the JAX
    int8 QK^T path operation for operation: a = max(max|x|, 1e-9), x8 =
    clip(round_half_even(x * (127 / a)), +-127). Returns (x8 int8, a fp32).
    Divisions are tensor by tensor: PyTorch computes `127.0 / t` as
    reciprocal(t) * 127, and on the card `t / 127.0` as t * (1 / 127), neither
    of which rounds as one division does."""
    xf = x.float()
    a = xf.abs().amax(-1).clamp_min(1e-9)
    inv = torch.full_like(a, 127.0) / a
    return torch.round(xf * inv[..., None]).clamp(-127, 127).to(torch.int8), a


def int8_qk_operands(q, k, scale: float):
    """(q8, k8, sq, sk) of int8 QK^T: q, k quantized per row, sq = (a_q / 127)
    * (scale * log2(e)) (B, Sq, Hq) and sk = a_k / 127 (B, Skv, Hkv), fp32, as
    the JAX wrapper makes them; base-2 scores are (q8 . k8) * sq * sk."""
    q8, qa = quantize_rows_int8(q)
    k8, ka = quantize_rows_int8(k)
    sq = (qa / torch.full_like(qa, 127.0)) * (scale * LOG2E)
    sk = ka / torch.full_like(ka, 127.0)
    return q8, k8, sq, sk


def flash_attention_int8_ref(q, k, v, *, scale: Optional[float] = None, causal=False,
                             segment_ids=None):
    """Plain version of the int8 QK^T inference form (the TPU kernel's
    `int8_qk` branch): `int8_qk_operands`, the int32 product (summed here in
    fp32, which is exact: |q8 . k8| <= 127^2 * 256 < 2^24), s = (s32 * sq) *
    sk, then a base-2 softmax in fp32, P rounded to v's dtype for P.V, the
    sum over fp32 P, the result in q's dtype. q: (B,Sq,H,D), k/v:
    (B,Skv,Hkv,D); causal is top-left aligned."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    q8, k8, sq, sk = int8_qk_operands(q, k, scale)
    g = q.shape[2] // k.shape[2]
    k8, sk = k8.repeat_interleave(g, dim=2), sk.repeat_interleave(g, dim=2)
    s32 = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float())
    s = s32 * sq.transpose(1, 2)[..., None] * sk.transpose(1, 2)[:, :, None, :]
    keep = _keep(q.shape[1], k.shape[1], causal, segment_ids, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)  # (B, H, Sq)
    _, ve = _expand_kv(k, v, q.shape[2])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), ve.float())
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _probs(qs, k, lse, causal, segment_ids):
    """p = exp2(qs . k - lse) in fp32, 0 where masked: (B, H, Sq, Skv)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - lse[..., None])
    keep = _keep(qs.shape[1], k.shape[1], causal, segment_ids, qs.device)
    return p if keep is None else p.masked_fill(~keep, 0.0)


def flash_fwd_lse_ref(qs, k, v, *, causal=False, segment_ids=None):
    """Plain version of the lse form (B15): qs is q * scale * log2(e) in q's
    dtype; returns o in v's dtype and the base-2 lse (B, H, Sq) fp32, the
    whole computation in fp32."""
    k, v = _expand_kv(k, v, qs.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    keep = _keep(qs.shape[1], k.shape[1], causal, segment_ids, qs.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s * math.log(2.0), dim=-1) * LOG2E
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp2(s - lse[..., None]), v.float())
    return o.to(v.dtype), lse


def flash_bwd_dkv_ref(qs, k, v, do, lse, di, *, causal=False, segment_ids=None):
    """Plain version of `_bwd_dkv_kernel` (B14): dk, dv in k's dtype, each
    query head's in fp32 summed over its GQA group. p is rounded to do's dtype
    for dv += p^T do and ds = p (dp - di) / log2(e) to qs's for dk += ds^T qs,
    as the kernels round them. di: (B, H, Sq) fp32."""
    b, skv, hkv, d = k.shape
    ke, ve = _expand_kv(k, v, qs.shape[2])
    p = _probs(qs, ke, lse, causal, segment_ids)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), ve.float())
    ds = p * (dp - di[..., None]) * (1.0 / LOG2E)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(qs.dtype).float(), qs.float())
    g = qs.shape[2] // hkv
    dk = dk.reshape(b, skv, hkv, g, d).sum(3)
    dv = dv.reshape(b, skv, hkv, g, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(qs, k, v, do, lse, di, *, scale: float, causal=False, segment_ids=None):
    """Plain version of `_bwd_dq_kernel` (B14): dq of the unscaled q, in qs's
    dtype; ds = p (dp - di) * scale is rounded to k's dtype for dq += ds k."""
    ke, ve = _expand_kv(k, v, qs.shape[2])
    p = _probs(qs, ke, lse, causal, segment_ids)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), ve.float())
    ds = p * (dp - di[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), ke.float()).to(qs.dtype)


# the tile of csrc/flash_bwd.cu's wgmma core that a skip is judged on: one
# consumer warpgroup's 64 owned rows against a walked tile of 64 rows
BWD_TILE = 64


def flash_bwd_tile_visits(sq, skv, causal=False, segment_ids=None):
    """(B or 1, ceil(Sq / 64), ceil(Skv / 64)) bool: the (query tile, key
    tile) pairs of BWD_TILE rows the backward kernels compute, by their rule.
    A pair is skipped when causal hides all of it (its last query before its
    first key) or when its query and key segment ids share no id (rows past
    each sequence's end left out): their [min, max] spans are disjoint, or
    their sets of id mod 32 are. Either way no pair of a skipped tile is
    visible, so skipping is exact."""
    tile = BWD_TILE
    nq, nk = -(-sq // tile), -(-skv // tile)
    q_last = (torch.arange(nq) * tile + tile - 1).clamp(max=sq - 1)
    visits = torch.ones((1, nq, nk), dtype=torch.bool)
    if causal:
        visits = visits & (q_last[:, None] >= torch.arange(nk) * tile)[None]
    if segment_ids is not None:
        def spans(seg, n):  # each tile's least and greatest id, and its ids mod 32
            seg = seg.detach().to("cpu", torch.int64)
            pad = n * tile - seg.shape[1]
            ids = F.pad(seg, (0, pad)).view(seg.shape[0], n, tile)
            valid = F.pad(torch.ones_like(seg, dtype=torch.bool), (0, pad)).view(ids.shape)
            lo = ids.masked_fill(~valid, torch.iinfo(torch.int64).max).amin(-1)
            hi = ids.masked_fill(~valid, torch.iinfo(torch.int64).min).amax(-1)
            bits = (F.one_hot(ids % 32, 32).bool() & valid[..., None]).any(2)
            return lo, hi, bits

        (qlo, qhi, qbits), (klo, khi, kbits) = spans(segment_ids.q, nq), spans(segment_ids.kv, nk)
        visits = visits & (qlo[:, :, None] <= khi[:, None, :]) \
            & (klo[:, None, :] <= qhi[:, :, None]) \
            & (qbits[:, :, None, :] & kbits[:, None, :, :]).any(-1)
    return visits


def _tiled_pairs(qs, k, lse, causal, segment_ids, visits):
    """Each visited (query tile, key tile) pair as (query rows, key rows, p):
    p = exp2(qs . k - lse) in fp32, 0 where masked and in the pair's batch
    rows that `visits` skips; k with its GQA groups expanded."""
    sq, skv, tile = qs.shape[1], k.shape[1], BWD_TILE
    if visits is None:
        visits = flash_bwd_tile_visits(sq, skv, causal, segment_ids)
    walk = visits.any(0).tolist()  # on the host: the pairs some batch row visits
    visits = visits.to(qs.device)
    keep = _keep(sq, skv, causal, segment_ids, qs.device)
    for i in range(visits.shape[1]):
        rq = slice(i * tile, min((i + 1) * tile, sq))
        for j in range(visits.shape[2]):
            if not walk[i][j]:
                continue
            rk = slice(j * tile, min((j + 1) * tile, skv))
            vis = visits[:, i, j]
            s = torch.einsum("bqhd,bkhd->bhqk", qs[:, rq].float(), k[:, rk].float())
            p = torch.exp2(s - lse[:, :, rq, None])
            m = vis[:, None, None, None]
            if keep is not None:
                m = m & keep[:, :, rq, rk]
            yield rq, rk, p.masked_fill(~m, 0.0)


def flash_bwd_dkv_tiled_ref(qs, k, v, do, lse, di, *, causal=False, segment_ids=None,
                            visits=None):
    """`flash_bwd_dkv_ref` summed over the (query tile, key tile) pairs the
    kernels compute (`flash_bwd_tile_visits`, or the `visits` given); a skipped
    pair adds nothing. Equal to the untiled version up to summation order
    when skipping is exact. Tests and chip_smoke.py use it."""
    b, skv, hkv, d = k.shape
    hq = qs.shape[2]
    ke, ve = _expand_kv(k, v, hq)
    dk = torch.zeros((b, skv, hq, d), dtype=torch.float32, device=qs.device)
    dv = torch.zeros_like(dk)
    for rq, rk, p in _tiled_pairs(qs, ke, lse, causal, segment_ids, visits):
        dv[:, rk] += torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do[:, rq].float())
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, rq].float(), ve[:, rk].float())
        ds = p * (dp - di[:, :, rq, None]) * (1.0 / LOG2E)
        dk[:, rk] += torch.einsum("bhqk,bqhd->bkhd", ds.to(qs.dtype).float(), qs[:, rq].float())
    g = hq // hkv
    dk = dk.reshape(b, skv, hkv, g, d).sum(3)
    dv = dv.reshape(b, skv, hkv, g, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_tiled_ref(qs, k, v, do, lse, di, *, scale: float, causal=False,
                           segment_ids=None, visits=None):
    """`flash_bwd_dq_ref` summed over the pairs the kernels compute, as
    `flash_bwd_dkv_tiled_ref` is."""
    ke, ve = _expand_kv(k, v, qs.shape[2])
    dq = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
    for rq, rk, p in _tiled_pairs(qs, ke, lse, causal, segment_ids, visits):
        dp = torch.einsum("bqhd,bkhd->bhqk", do[:, rq].float(), ve[:, rk].float())
        ds = p * (dp - di[:, :, rq, None]) * scale
        dq[:, rq] += torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), ke[:, rk].float())
    return dq.to(qs.dtype)


# ------------------------------------------------------------------ kernels
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _flash_fn(int8: bool):
    from ..kernels import load_library

    lib = load_library("flash_fwd")
    fn = lib.flash_fwd_int8qk_bf16 if int8 else lib.flash_fwd_bf16
    fn.argtypes = [_P] * 4 + [_I] * 17 + [ctypes.c_float] + [_I] * 2 + [_P] * 2 + [_I] * 2 \
        + [_P] * (5 if int8 else 2)
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _quantize_fn():
    from ..kernels import load_library

    fn = load_library("flash_fwd").flash_int8_quantize
    fn.argtypes = [_P] * 6 + [_I] * 12 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _flash_bwd_fns():
    from ..kernels import load_library

    lib = load_library("flash_bwd")
    dkv, dq = lib.flash_bwd_dkv_bf16, lib.flash_bwd_dq_bf16
    strides = ctypes.POINTER(ctypes.c_int)
    dkv.argtypes = [_P] * 10 + [_I] * 10 + [strides, _P]
    dq.argtypes = [_P] * 9 + [_I] * 10 + [strides, ctypes.c_float, _P]
    dkv.restype = dq.restype = _I
    return dkv, dq


def _kernel_operand(t):
    """t itself when the kernels can read it through its strides (unit
    stride over head_dim, 16-byte aligned rows, strides below 2**31), else a
    contiguous copy."""
    if t.stride(-1) != 1 or any(s % 8 or s >= 2 ** 31 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _check_operands(name, q, k, v, causal, segment_ids, dims=_KERNEL_HEAD_DIMS):
    """Device, dtype and shape checks; returns the head_dim the kernel is
    compiled for (the least of `dims` >= d) and the int32 segment arrays or
    None."""
    b, sq, hq, d = q.shape
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {tname} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, got {tname} {t.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if causal and sq != k.shape[1]:
        raise ValueError(f"{name}: causal needs Sq == Skv (top-left mask), got {sq} != "
                         f"{k.shape[1]}")
    if d > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"{name} kernel takes head_dim <= {_KERNEL_HEAD_DIMS[-1]}, got {d}")
    segs = None
    if segment_ids is not None:
        segs = tuple(s.to(device=q.device, dtype=torch.int32).contiguous()
                     for s in segment_ids)
        if segs[0].shape != (b, sq) or segs[1].shape != (b, k.shape[1]):
            raise ValueError(f"{name}: segment ids {tuple(segs[0].shape)} / "
                             f"{tuple(segs[1].shape)} do not match q {tuple(q.shape)} "
                             f"k {tuple(k.shape)}")
    return next(x for x in dims if x >= d), segs


def _segment_args(segs, sq, skv):
    """(qseg, kseg, qseg batch stride, kseg batch stride) for the kernels."""
    return (segs[0].data_ptr(), segs[1].data_ptr(), sq, skv) if segs else (None, None, 0, 0)


def _pad_head_dim(d_kernel, *ts):
    """Zero columns change neither q.k nor the first d columns of p.v."""
    return tuple(t if t.shape[-1] == d_kernel else F.pad(t, (0, d_kernel - t.shape[-1]))
                 for t in ts)


def _quantize_qk_cuda(q, k, scale_log2):
    """The int8 QK^T form's activation pass on kernel operands (bf16, unit
    stride over a compiled head_dim): q8 (B, Sq, H, D) and k8
    (B, Skv, KVH, D) int8, contiguous; sq (B, H, Sq) = (a_q / 127) *
    scale_log2 and sk (B, KVH, Skv) = a_k / 127, fp32."""
    b, sq_len, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
    sq = torch.empty((b, h, sq_len), dtype=torch.float32, device=q.device)
    sk = torch.empty((b, hkv, skv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _quantize_fn()(q.data_ptr(), k.data_ptr(), q8.data_ptr(), k8.data_ptr(),
                             sq.data_ptr(), sk.data_ptr(), b, h, hkv, sq_len, skv, d,
                             *q.stride()[:3], *k.stride()[:3], scale_log2,
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_int8_quantize launch failed with cudaError {err}")
    return q8, k8, sq, sk


def quantize_qk_int8(q, k, scale: float):
    """(q8, k8, sq, sk) of int8 QK^T, as `int8_qk_operands` makes them: sq
    (B, Sq, Hq) and sk (B, Skv, Hkv) fp32. CUDA tensors launch the activation
    pass that `flash_attention_int8` runs before its wgmma core, on q and k
    padded to the compiled head_dim as the wrapper pads them (q8 and k8 are
    views of its first d columns, sq and sk of its (B, H, S) scales); CPU
    tensors run `int8_qk_operands`."""
    if q.is_cuda:
        d = q.shape[3]
        d_kernel, _ = _check_operands("quantize_qk_int8", q, k, k, False, None)
        q, k = (_kernel_operand(t) for t in _pad_head_dim(d_kernel, q, k))
        q8, k8, sq, sk = _quantize_qk_cuda(q, k, scale * LOG2E)
        return q8[..., :d], k8[..., :d], sq.transpose(1, 2), sk.transpose(1, 2)
    _cpu_only("quantize_qk_int8", q)
    return int8_qk_operands(q, k, scale)


def _flash_fwd_cuda(q, k, v, scale_log2, causal, segment_ids, want_lse, int8=False):
    b, sq, h, d = q.shape
    d_kernel, segs = _check_operands("flash_attention", q, k, v, causal, segment_ids)
    q, k, v = (_kernel_operand(t) for t in _pad_head_dim(d_kernel, q, k, v))
    o = torch.empty((b, sq, h, d_kernel), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
    # int8 QK^T on the wgmma core: the activation pass first, on the same stream
    operands = _quantize_qk_cuda(q, k, scale_log2) \
        if int8 and flash_fwd_uses_wgmma(d_kernel) else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, k.shape[1],
                d_kernel, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                scale_log2, h // k.shape[2], int(causal), *_segment_args(segs, sq, k.shape[1])]
        if int8:
            args += [None] * 4 if operands is None else [t.data_ptr() for t in operands]
        else:
            args.append(None if lse is None else lse.data_ptr())
        err = _flash_fn(int8)(*args, stream)
    if err:
        raise RuntimeError(f"flash_fwd_{'int8qk_' if int8 else ''}bf16 launch failed with "
                           f"cudaError {err}")
    return (o[..., :d] if d_kernel != d else o), lse


@functools.lru_cache(maxsize=None)
def flash_bwd_core(d_kernel: int):
    """(core, dynamic shared memory a block) of the backward kernels at a
    compiled head_dim: the fixed table of csrc/flash_bwd.cu (`flash_bwd_core`),
    "wgmma" at 64 and 128, "wmma" (0 here) at the others."""
    from ..kernels import load_library

    fn = load_library("flash_bwd").flash_bwd_core
    fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    smem = ctypes.c_int(0)
    return ("wgmma" if fn(d_kernel, ctypes.byref(smem)) else "wmma"), smem.value


def _flash_bwd_cuda(dkv, qs, k, v, do, lse, di, scale, causal, segment_ids):
    """dkv: [dk, dv] in k's layout; else [dq] in qs's; bf16. The wgmma core
    reads a head of a multiple of 8 columns as it is (the compiled width's
    columns past it read as zeros) and writes the gradients so, each GQA group
    summed in the kernel; the WMMA core takes the head padded to its width
    and writes fp32 (B, H, S_pad, D) of each query head, summed, transposed
    and cast here."""
    b, sq, h, d = qs.shape
    hkv = k.shape[2]
    d_kernel, segs = _check_operands("flash_attention backward", qs, k, v, causal, segment_ids,
                                     _BWD_HEAD_DIMS)
    if do.shape != qs.shape or do.dtype != qs.dtype or do.device != qs.device:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(qs.shape)} {qs.dtype}")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be contiguous fp32 "
                             f"{(b, h, sq)}, got {t.dtype} {tuple(t.shape)}")
    rows = k.shape[1] if dkv else sq
    wgmma = flash_bwd_core(d_kernel)[0] == "wgmma"
    dh = d if wgmma and d % 8 == 0 else d_kernel
    qs, k, v, do = (_kernel_operand(t) for t in _pad_head_dim(dh, qs, k, v, do))
    if wgmma:
        out_shape, out_dtype = (b, rows, hkv if dkv else h, dh), qs.dtype
    else:
        out_shape, out_dtype = (b, h, -(-rows // 64) * 64, d_kernel), torch.float32
    outs = [torch.empty(out_shape, dtype=out_dtype, device=qs.device)
            for _ in range(2 if dkv else 1)]
    strides = (ctypes.c_int * 12)(*qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *do.stride()[:3])
    args = [qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), *_segment_args(segs, sq, k.shape[1])[:2],
            *(o.data_ptr() for o in outs), b, h, sq, k.shape[1], d_kernel, dh, h // hkv,
            int(causal), *_segment_args(segs, sq, k.shape[1])[2:], strides]
    fn_dkv, fn_dq = _flash_bwd_fns()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn_dkv(*args, stream) if dkv else fn_dq(*args, scale, stream)
    if err:
        raise RuntimeError(f"flash_bwd_{'dkv' if dkv else 'dq'}_bf16 launch failed with "
                           f"cudaError {err}")
    if wgmma:
        return [o[..., :d] for o in outs]
    outs = [o[:, :, :rows, :d] for o in outs]
    if dkv and hkv != h:
        outs = [o.reshape(b, hkv, h // hkv, rows, d).sum(2) for o in outs]
    return [o.transpose(1, 2).to(qs.dtype) for o in outs]


def _cpu_only(name, t):
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")


def flash_fwd_lse(qs, k, v, *, causal=False, segment_ids=None):
    """The lse form of the forward (B15): qs = q * scale * log2(e) in q's
    dtype; returns (o (B, Sq, H, D) in q's dtype, the base-2 lse (B, H, Sq)
    fp32). CUDA tensors launch the kernel; CPU tensors run
    `flash_fwd_lse_ref`."""
    if qs.is_cuda:
        refuse_grad("flash_fwd_lse", qs, k, v)
        out = _flash_fwd_cuda(qs, k, v, 1.0, causal, segment_ids, True)
        flash_fwd_lse.launches += 1
        flash_fwd_lse.launches_by_dim[qs.shape[3]] += 1
        return out
    _cpu_only("flash_fwd_lse", qs)
    return flash_fwd_lse_ref(qs, k, v, causal=causal, segment_ids=segment_ids)


flash_fwd_lse.launches = 0  # kernel launches (CUDA tensors only)
flash_fwd_lse.launches_by_dim = Counter()  # the same, by the caller's head_dim


def flash_bwd_dkv(qs, k, v, do, lse, di, *, causal=False, segment_ids=None):
    """dk, dv (B14, `_bwd_dkv_kernel`) in k's dtype from the lse form's
    operands, do and di (B, H, Sq) fp32, each GQA group's query heads summed.
    CUDA tensors launch the kernel; CPU tensors run `flash_bwd_dkv_ref`."""
    if qs.is_cuda:
        dk, dv = _flash_bwd_cuda(True, qs, k, v, do, lse, di, 0.0, causal, segment_ids)
        flash_bwd_dkv.launches += 1
        flash_bwd_dkv.launches_by_dim[qs.shape[3]] += 1
        return dk, dv
    _cpu_only("flash_bwd_dkv", qs)
    return flash_bwd_dkv_ref(qs, k, v, do, lse, di, causal=causal, segment_ids=segment_ids)


flash_bwd_dkv.launches = 0  # kernel launches (CUDA tensors only)
flash_bwd_dkv.launches_by_dim = Counter()  # the same, by the caller's head_dim


def flash_bwd_dq(qs, k, v, do, lse, di, *, scale: float, causal=False, segment_ids=None):
    """dq of the unscaled q (B14, `_bwd_dq_kernel`) in qs's dtype. CUDA
    tensors launch the kernel; CPU tensors run `flash_bwd_dq_ref`."""
    if qs.is_cuda:
        (dq,) = _flash_bwd_cuda(False, qs, k, v, do, lse, di, scale, causal, segment_ids)
        flash_bwd_dq.launches += 1
        flash_bwd_dq.launches_by_dim[qs.shape[3]] += 1
        return dq
    _cpu_only("flash_bwd_dq", qs)
    return flash_bwd_dq_ref(qs, k, v, do, lse, di, scale=scale, causal=causal,
                            segment_ids=segment_ids)


flash_bwd_dq.launches = 0  # kernel launches (CUDA tensors only)
flash_bwd_dq.launches_by_dim = Counter()  # the same, by the caller's head_dim


class _FlashAttention(torch.autograd.Function):
    """The JAX `_flash_attention` custom_vjp: the forward keeps (qs, k, v, o,
    lse) and the backward runs the two B14 kernels. The module's functions are
    looked up at each call, so that a caller can swap in plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, scale, causal):
        qs = (q.float() * (scale * LOG2E)).to(q.dtype)  # as the JAX wrapper rounds it
        segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        o, lse = flash_fwd_lse(qs, k, v, causal=causal, segment_ids=segs)
        ctx.save_for_backward(qs, k, v, o, lse, seg_q, seg_kv)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, Sq)
        dk, dv = flash_bwd_dkv(qs, k, v, do, lse, di, causal=ctx.causal, segment_ids=segs)
        dq = flash_bwd_dq(qs, k, v, do, lse, di, scale=ctx.scale, causal=ctx.causal,
                          segment_ids=segs)
        return dq, dk, dv, None, None, None, None


def flash_attention_int8(q, k, v, *, scale: Optional[float] = None, causal=False,
                         segment_ids: Optional[SegmentIds] = None):
    """The inference form with int8 QK^T, (B, S, H, D) layout. CUDA tensors
    launch the kernel (no gradient): at compiled head dims 64 and 128 the
    activation pass and then the wgmma core, counted once a call; CPU tensors
    run `flash_attention_int8_ref`."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.is_cuda:
        refuse_grad("flash_attention_int8", q, k, v)
        o, _ = _flash_fwd_cuda(q, k, v, scale * LOG2E, causal, segment_ids, False, int8=True)
        flash_attention_int8.launches += 1
        return o
    _cpu_only("flash_attention_int8", q)
    return flash_attention_int8_ref(q, k, v, scale=scale, causal=causal,
                                    segment_ids=segment_ids)


flash_attention_int8.launches = 0  # kernel launches (CUDA tensors only)


def flash_attention(q, k, v, *, causal=False, scale: Optional[float] = None,
                    segment_ids: Optional[SegmentIds] = None, int8_qk: Optional[bool] = None):
    """Flash attention, (B, S, H, D) layout (port of `flash_attention`). Under
    autograd it is `_FlashAttention` (lse forward, B14 backward); otherwise
    `int8_qk` (default: PMIX_INT8_ATTN=1, as in JAX) goes to
    `flash_attention_int8`, and else CUDA tensors launch the inference form
    of the forward kernel and CPU tensors run `flash_attention_ref`. causal
    is top-left aligned and needs Sq == Skv, as in JAX."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention causal requires sq == skv, got {q.shape[1]} != "
                         f"{k.shape[1]}")
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if grad_needed(q, k, v):
        seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
        return _FlashAttention.apply(q, k, v, seg_q, seg_kv, scale, causal)
    if int8_qk_default() if int8_qk is None else int8_qk:
        return flash_attention_int8(q, k, v, scale=scale, causal=causal,
                                    segment_ids=segment_ids)
    if q.is_cuda:
        o, _ = _flash_fwd_cuda(q, k, v, scale * LOG2E, causal, segment_ids, False)
        flash_attention.launches += 1
        flash_attention.launches_by_dim[q.shape[3]] += 1
        return o
    _cpu_only("flash_attention", q)
    return flash_attention_ref(q, k, v, scale=scale, causal=causal, segment_ids=segment_ids)


flash_attention.launches = 0  # inference-form kernel launches (CUDA tensors only)
flash_attention.launches_by_dim = Counter()  # the same, by the caller's head_dim


def flash_attention_with_lse(q, k, v, *, segment_ids: Optional[SegmentIds] = None,
                             scale: Optional[float] = None, causal: bool = False):
    """(o, lse) with lse in BASE 2, (B, S, H) fp32 (port of
    `flash_attention_with_lse`): the lse form of the forward on q pre-scaled
    as the JAX wrapper pre-scales it. No gradient, as in JAX."""
    scale = q.shape[3] ** -0.5 if scale is None else scale
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    o, lse = flash_fwd_lse(qs, k, v, causal=causal, segment_ids=segment_ids)
    return o, lse.transpose(1, 2)


def use_flash(q_shape, k_shape, *, bias=None, causal=False) -> bool:
    """The JAX package's flash-or-math rule (paddlemix_tpu/ops/attention.py
    scaled_dot_product_attention), from shapes alone: head_dim up to 256 (the
    kernels pad 129-160 to 160 and 161-256 to 256)."""
    b, sq, hq, d = q_shape
    skv = k_shape[1]
    return (bias is None and skv >= 128 and d <= _KERNEL_HEAD_DIMS[-1]
            # unaligned short sequences go to math unless the score tensor is large
            and (skv % 128 == 0 or skv >= 1024 or b * hq * sq * skv * 4 > 1e9)
            # the flash causal mask is top-left aligned, math's bottom-right
            and (not causal or sq == skv))


def scaled_dot_product_attention(q, k, v, *, bias=None, causal=False,
                                 segment_ids: Optional[SegmentIds] = None,
                                 scale: Optional[float] = None):
    """Attention routed to flash or math by `use_flash`, (B, S, H, D) layout;
    the calls that go to flash take int8 QK^T where PMIX_INT8_ATTN=1, as in
    JAX."""
    if use_flash(q.shape, k.shape, bias=bias, causal=causal):
        return flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    return attention_math(q, k, v, bias=bias, causal=causal, segment_ids=segment_ids,
                          scale=scale)
