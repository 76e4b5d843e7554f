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
  P.V); `flash_fwd_lse` its lse form (B15), on q pre-scaled by
  scale * log2(e) and rounded to q's dtype as the JAX wrapper does, writing
  the base-2 lse of each row, fp32 (B, H, S);
- `csrc/flash_bwd.cu`: the backward (B14), `flash_bwd_dkv` and
  `flash_bwd_dq`, from that pre-scaled q, the lse and di = rowsum(o * do), at
  the forward's head dims (129-160 padded to 160, 161-256 to 256).
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
# head dims compiled into flash_fwd.cu and flash_bwd.cu
_KERNEL_HEAD_DIMS = (32, 64, 96, 128, 160, 256)


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


# ------------------------------------------------------------------ kernels
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _flash_fn(int8: bool):
    from ..kernels import load_library

    lib = load_library("flash_fwd")
    fn = lib.flash_fwd_int8qk_bf16 if int8 else lib.flash_fwd_bf16
    fn.argtypes = [_P] * 4 + [_I] * 17 + [ctypes.c_float] + [_I] * 2 + [_P] * 2 + [_I] * 2 \
        + [_P] * (1 if int8 else 2)
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _flash_bwd_fns():
    from ..kernels import load_library

    lib = load_library("flash_bwd")
    dkv, dq = lib.flash_bwd_dkv_bf16, lib.flash_bwd_dq_bf16
    strides = ctypes.POINTER(ctypes.c_int)
    dkv.argtypes = [_P] * 10 + [_I] * 9 + [strides, _P]
    dq.argtypes = [_P] * 9 + [_I] * 9 + [strides, ctypes.c_float, _P]
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


def _check_operands(name, q, k, v, causal, segment_ids):
    """Device, dtype and shape checks; returns the head_dim the kernel is
    compiled for (the least of `_KERNEL_HEAD_DIMS` >= d) and the int32
    segment arrays or None."""
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
    return next(x for x in _KERNEL_HEAD_DIMS if x >= d), segs


def _segment_args(segs, sq, skv):
    """(qseg, kseg, qseg batch stride, kseg batch stride) for the kernels."""
    return (segs[0].data_ptr(), segs[1].data_ptr(), sq, skv) if segs else (None, None, 0, 0)


def _pad_head_dim(d_kernel, *ts):
    """Zero columns change neither q.k nor the first d columns of p.v."""
    return tuple(t if t.shape[-1] == d_kernel else F.pad(t, (0, d_kernel - t.shape[-1]))
                 for t in ts)


def _flash_fwd_cuda(q, k, v, scale_log2, causal, segment_ids, want_lse, int8=False):
    b, sq, h, d = q.shape
    d_kernel, segs = _check_operands("flash_attention", q, k, v, causal, segment_ids)
    q, k, v = (_kernel_operand(t) for t in _pad_head_dim(d_kernel, q, k, v))
    o = torch.empty((b, sq, h, d_kernel), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq, k.shape[1],
                d_kernel, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                scale_log2, h // k.shape[2], int(causal), *_segment_args(segs, sq, k.shape[1])]
        if not int8:
            args.append(None if lse is None else lse.data_ptr())
        err = _flash_fn(int8)(*args, stream)
    if err:
        raise RuntimeError(f"flash_fwd_{'int8qk_' if int8 else ''}bf16 launch failed with "
                           f"cudaError {err}")
    return (o[..., :d] if d_kernel != d else o), lse


def _flash_bwd_cuda(dkv, qs, k, v, do, lse, di, scale, causal, segment_ids):
    """dkv: (dk, dv) fp32 of each query head; else dq fp32; (B, H, S_pad, D)."""
    b, sq, h, d = qs.shape
    d_kernel, segs = _check_operands("flash_attention backward", qs, k, v, causal, segment_ids)
    if do.shape != qs.shape or do.dtype != qs.dtype or do.device != qs.device:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(qs.shape)} {qs.dtype}")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be contiguous fp32 "
                             f"{(b, h, sq)}, got {t.dtype} {tuple(t.shape)}")
    qs, k, v, do = (_kernel_operand(t) for t in _pad_head_dim(d_kernel, qs, k, v, do))
    rows = k.shape[1] if dkv else sq
    out_shape = (b, h, -(-rows // 64) * 64, d_kernel)
    outs = [torch.empty(out_shape, dtype=torch.float32, device=qs.device)
            for _ in range(2 if dkv else 1)]
    strides = (ctypes.c_int * 12)(*qs.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                  *do.stride()[:3])
    args = [qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), *_segment_args(segs, sq, k.shape[1])[:2],
            *(o.data_ptr() for o in outs), b, h, sq, k.shape[1], d_kernel, h // k.shape[2],
            int(causal), *_segment_args(segs, sq, k.shape[1])[2:], strides]
    fn_dkv, fn_dq = _flash_bwd_fns()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn_dkv(*args, stream) if dkv else fn_dq(*args, scale, stream)
    if err:
        raise RuntimeError(f"flash_bwd_{'dkv' if dkv else 'dq'}_bf16 launch failed with "
                           f"cudaError {err}")
    return [o[:, :, :rows, :d] for o in outs]


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
    operands, do and di (B, H, Sq) fp32. CUDA tensors launch the kernel, whose
    per-query-head fp32 outputs are summed over each GQA group here; CPU
    tensors run `flash_bwd_dkv_ref`."""
    if qs.is_cuda:
        dk, dv = _flash_bwd_cuda(True, qs, k, v, do, lse, di, 0.0, causal, segment_ids)
        flash_bwd_dkv.launches += 1
        flash_bwd_dkv.launches_by_dim[qs.shape[3]] += 1
        b, h, skv, d = dk.shape
        hkv = k.shape[2]
        if hkv != h:
            dk, dv = (t.reshape(b, hkv, h // hkv, skv, d).sum(2) for t in (dk, dv))
        return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)
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
        return dq.transpose(1, 2).to(qs.dtype)
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
    launch the kernel (no gradient); CPU tensors run
    `flash_attention_int8_ref`."""
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
