"""GroupNorm (+SiLU) over channel-minor (..., C) tensors, RMSNorm, the adaLN
pair of the SD3 MM-DiT (adaptive LayerNorm, and adaptive LayerNorm fused with
the gated residual add) and LayerNorm with its backward (B10; see their
sections below). Port of paddlemix_tpu/ops/norms.py.

RMSNorm (B11): `rms_norm` launches a Triton kernel for CUDA tensors and runs
its plain version `rms_norm_ref` for CPU tensors. It replaces the forward
Pallas kernel `_rms_norm_pallas_fwd_impl` / `_rms_fwd_kernel`: fp32 mean of
x^2, rsqrt(+eps), times the fp32 weight, cast to x's dtype. One program
normalises one row (Llama-7B: 4096 wide, 8 KB in bf16), so the kernel reads
x once and writes y once: it is bound by those bytes, and a single-row call
(decode) by its launch. The JAX package sends fewer than 64 rows to XLA,
which fuses the norm into its neighbours; eager PyTorch has no such fusion,
and the plain version is about six launches, so the port launches the
kernel for every row count. Under autograd `rms_norm` is `_RMSNorm` (the JAX
custom_vjp), whose backward `rms_norm_backward` is a second Triton kernel
(see its section below).

GroupNorm (B4), adaLN (B12) and fused adaLN + residual (B13) take their
backward, as the JAX package takes it from XLA, from autograd of their plain
versions, recomputed (`ops.autograd.with_plain_backward`).

`group_norm` launches the Triton kernel below for CUDA tensors and runs its
plain version `group_norm_ref` for CPU tensors. `group_norm_stats` runs the
kernel's first two passes alone: the per-(batch, group) mean and rstd that
the fused GroupNorm+SiLU+int8-conv path turns into its affine.

The kernel replaces the Pallas kernel `_group_norm_pallas_impl` / `_gn_kernel`
(paddlemix_tpu/ops/norms.py). GroupNorm is memory-bound: it does a few flops
per element, so its floor is reading x twice and writing y once (3 passes over
2 bytes an element in bf16). The TPU kernel carried per-channel sums across a
sequential grid; on Hopper the blocks run in parallel and in no order, so the
reduction is split in three launches:
  1. partial sums: many programs, each a (batch, row range, 64-channel) tile,
     write per-channel fp32 sums of x and x^2 for its rows. One program per
     (batch, group) would leave the card idle: at the VAE's (1, 1024, 1024, 256)
     that is 32 programs over 8 M elements each;
  2. group stats: one tiny program per (batch, group) adds the partials and
     writes mean and rstd, with the E[x^2] - E[x]^2 variance clamped at 0;
  3. apply: the same tiling as pass 1 normalises, applies the affine and the
     optional SiLU in fp32 and stores in the input dtype.
Channel tiles are 64 wide, so every SDXL width (128 ... 2560) tiles exactly;
rows and channels are masked at the edges, so any shape with C % groups == 0
is taken.
"""

from __future__ import annotations

import functools
import math

import torch

from .autograd import grad_needed, with_plain_backward

_BLOCK_R = 64        # rows per tile
_BLOCK_C = 64        # channels per tile
_TARGET_PROGRAMS = 1024  # ~8 programs per SM on a 132-SM card


def _group_moments(x, groups: int, eps: float):
    """Per-(batch, group) fp32 mean and rsqrt(var + eps) of (B, ..., C), from
    per-channel moments, variance E[x^2] - E[x]^2 clamped at 0."""
    cpg = x.shape[-1] // groups
    red = tuple(range(1, x.ndim - 1))
    n = float(math.prod(x.shape[1:-1]) * cpg)
    xf = x.float()
    s = xf.sum(dim=red) if red else xf         # (B, C)
    s2 = (xf * xf).sum(dim=red) if red else xf * xf
    gs = s.reshape(-1, groups, cpg).sum(-1)    # (B, G)
    gs2 = s2.reshape(-1, groups, cpg).sum(-1)
    mean = gs / n
    var = torch.clamp(gs2 / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def group_norm_ref(x, weight, bias, groups: int, eps: float = 1e-5, act: str = "none"):
    """Plain version (port of `group_norm_silu_xla`): per-channel fp32 moments,
    aggregated per group, variance E[x^2] - E[x]^2 clamped at 0."""
    c = x.shape[-1]
    cpg = c // groups
    mean, inv = _group_moments(x, groups, eps)
    mean_c = mean.repeat_interleave(cpg, dim=-1)  # (B, C)
    inv_c = inv.repeat_interleave(cpg, dim=-1)
    scale = inv_c * weight.float()
    shift = bias.float() - mean_c * scale
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
    y = x.float() * scale.reshape(bshape) + shift.reshape(bshape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels. Triton is imported here, at first launch, so
    that this module imports where Triton is absent; `tl` is bound as a module
    global because Triton resolves the names a kernel uses in its globals."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def gn_partial_sums(x_ptr, psum_ptr, psq_ptr, n_rows, C, rows_per_prog, n_rtiles,
                        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        t = tl.program_id(1)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        base = x_ptr + b.to(tl.int64) * n_rows * C
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r0 in range(0, rows_per_prog, BLOCK_R):
            rows = t * rows_per_prog + r0 + tl.arange(0, BLOCK_R)
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(base + offs, mask=mask, other=0.0).to(tl.float32)
            acc += tl.sum(x, axis=0)
            acc2 += tl.sum(x * x, axis=0)
        out = (b * n_rtiles + t) * C + cols
        tl.store(psum_ptr + out, acc, mask=cmask)
        tl.store(psq_ptr + out, acc2, mask=cmask)

    @triton.jit
    def gn_group_stats(psum_ptr, psq_ptr, mean_ptr, rstd_ptr, n_rtiles, C, cpg, groups,
                       count, eps, BLOCK_T: tl.constexpr, BLOCK_G: tl.constexpr):
        b = tl.program_id(0)
        g = tl.program_id(1)
        lane = tl.arange(0, BLOCK_G)
        cols = g * cpg + lane
        s = tl.zeros([BLOCK_T, BLOCK_G], dtype=tl.float32)
        s2 = tl.zeros([BLOCK_T, BLOCK_G], dtype=tl.float32)
        for t0 in range(0, n_rtiles, BLOCK_T):
            ts = t0 + tl.arange(0, BLOCK_T)
            mask = (ts < n_rtiles)[:, None] & (lane < cpg)[None, :]
            offs = (b * n_rtiles + ts)[:, None] * C + cols[None, :]
            s += tl.load(psum_ptr + offs, mask=mask, other=0.0)
            s2 += tl.load(psq_ptr + offs, mask=mask, other=0.0)
        mean = tl.sum(tl.sum(s, axis=1), axis=0) / count
        var = tl.maximum(tl.sum(tl.sum(s2, axis=1), axis=0) / count - mean * mean, 0.0)
        tl.store(mean_ptr + b * groups + g, mean)
        tl.store(rstd_ptr + b * groups + g, 1.0 / tl.sqrt(var + eps))

    @triton.jit
    def gn_apply(x_ptr, y_ptr, w_ptr, bias_ptr, mean_ptr, rstd_ptr, n_rows, C, cpg, groups,
                 rows_per_prog, SILU: tl.constexpr, BLOCK_R: tl.constexpr,
                 BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        t = tl.program_id(1)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        gid = cols // cpg
        mean = tl.load(mean_ptr + b * groups + gid, mask=cmask, other=0.0)
        rstd = tl.load(rstd_ptr + b * groups + gid, mask=cmask, other=0.0)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        bb = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        scale = rstd * w
        shift = bb - mean * scale
        base = b.to(tl.int64) * n_rows * C
        for r0 in range(0, rows_per_prog, BLOCK_R):
            rows = t * rows_per_prog + r0 + tl.arange(0, BLOCK_R)
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = base + rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = x * scale[None, :] + shift[None, :]
            if SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return gn_partial_sums, gn_group_stats, gn_apply


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_input(x, weight, bias):
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"group_norm kernel takes bf16/fp16/fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"group_norm kernel needs a contiguous channel-minor tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.device != x.device or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"group_norm: {name} must be a contiguous ({c},) tensor on "
                             f"{x.device}, got {tuple(p.shape)} on {p.device}")


def _tiling(x):
    bsz, c = x.shape[0], x.shape[-1]
    n_rows = math.prod(x.shape[1:-1])
    n_ctiles = _cdiv(c, _BLOCK_C)
    rows_per_prog = _cdiv(_cdiv(bsz * n_rows * n_ctiles, _TARGET_PROGRAMS), _BLOCK_R) * _BLOCK_R
    return n_rows, n_ctiles, rows_per_prog, _cdiv(n_rows, rows_per_prog)


def _stats_triton(x, groups, eps):
    """Passes 1 and 2: per-(batch, group) fp32 mean and rstd."""
    bsz, c = x.shape[0], x.shape[-1]
    n_rows, n_ctiles, rows_per_prog, n_rtiles = _tiling(x)
    cpg = c // groups
    partial_sums, group_stats, _ = _kernels()
    f32 = dict(dtype=torch.float32, device=x.device)
    psum = torch.empty((bsz, n_rtiles, c), **f32)
    psq = torch.empty((bsz, n_rtiles, c), **f32)
    mean = torch.empty((bsz, groups), **f32)
    rstd = torch.empty((bsz, groups), **f32)
    with torch.cuda.device(x.device):
        partial_sums[(bsz, n_rtiles, n_ctiles)](x, psum, psq, n_rows, c, rows_per_prog,
                                                 n_rtiles, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C,
                                                 num_warps=4)
        group_stats[(bsz, groups)](psum, psq, mean, rstd, n_rtiles, c, cpg, groups,
                                   float(n_rows * cpg), float(eps), BLOCK_T=32,
                                   BLOCK_G=max(16, 1 << (cpg - 1).bit_length()), num_warps=4)
    return mean, rstd


def _group_norm_triton(x, weight, bias, groups, eps, act):
    _check_input(x, weight, bias)
    bsz, c = x.shape[0], x.shape[-1]
    n_rows, n_ctiles, rows_per_prog, n_rtiles = _tiling(x)
    mean, rstd = _stats_triton(x, groups, eps)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernels()[2][(bsz, n_rtiles, n_ctiles)](
            x, y, weight, bias, mean, rstd, n_rows, c, c // groups, groups, rows_per_prog,
            SILU=act == "silu", BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C, num_warps=4)
    group_norm.launches += 1
    return y


def _check_groups(x, groups):
    if x.ndim < 2 or x.shape[-1] % groups:
        raise ValueError(f"group_norm: channels {tuple(x.shape)[-1:]} not divisible by "
                         f"groups {groups} (shape {tuple(x.shape)})")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"group_norm: unsupported device {x.device}")


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5, act: str = "none"):
    """GroupNorm over (B, ..., C) with optional fused SiLU (port of `group_norm`).

    CUDA tensors launch the Triton kernel, whose backward is autograd of the
    plain version; CPU tensors run `group_norm_ref`."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm act must be 'none' or 'silu', got {act!r}")
    _check_groups(x, groups)
    if x.is_cuda:
        return with_plain_backward(
            lambda x_, w_, b_: _group_norm_triton(x_, w_, b_, groups, eps, act),
            lambda x_, w_, b_: group_norm_ref(x_, w_, b_, groups, eps, act), x, weight, bias)
    return group_norm_ref(x, weight, bias, groups, eps, act)


group_norm.launches = 0  # kernel launches (CUDA tensors only)


def group_norm_stats(x, groups: int, eps: float = 1e-5):
    """Per-(batch, group) fp32 (mean, rsqrt(var + eps)) of (B, ..., C), each
    (B, groups): the kernel's statistics passes alone, which the fused
    GroupNorm+SiLU+int8-conv path (ops/fused_resnet.py) turns into its affine.
    CUDA tensors launch passes 1 and 2; CPU tensors run the plain moments."""
    _check_groups(x, groups)
    if x.is_cuda:
        _check_input(x, None, None)

        def run(x_):
            out = _stats_triton(x_, groups, eps)
            group_norm_stats.launches += 1
            return out
        return with_plain_backward(run, lambda x_: _group_moments(x_, groups, eps), x)
    return _group_moments(x, groups, eps)


group_norm_stats.launches = 0  # statistics-pass launches (CUDA tensors only)


# ---------------------------------------------------------------- RMSNorm
_RMS_MAX_WIDTH = 16384  # one row in one program's registers


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """Plain version (port of `rms_norm_xla`): x * rsqrt(mean(x^2) + eps) * w,
    all in fp32, cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rms_kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_fwd(x_ptr, w_ptr, y_ptr, H, eps, BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        x = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(tl.sum(x * x, axis=0) / H + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * H + cols, (y * w).to(y_ptr.dtype.element_ty), mask=mask)

    return rms_norm_fwd


def _rms_norm_triton(x, weight, eps):
    h = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32) or not x.is_contiguous() \
            or h > _RMS_MAX_WIDTH:
        raise ValueError(f"rms_norm kernel takes a contiguous bf16/fp16/fp32 tensor at most "
                         f"{_RMS_MAX_WIDTH} wide, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if weight.device != x.device or weight.shape != (h,) or not weight.is_contiguous():
        raise ValueError(f"rms_norm: weight must be a contiguous ({h},) tensor on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")
    y = torch.empty_like(x)
    rows = x.numel() // h
    block = max(128, 1 << (h - 1).bit_length())
    with torch.cuda.device(x.device):
        _rms_kernel()[(rows,)](x, weight, y, h, float(eps), BLOCK_H=block,
                               num_warps=min(16, max(1, block // 512)))
    rms_norm.launches += 1
    return y


def _rms_forward(x, weight, eps):
    """The forward: the kernel for CUDA tensors, `rms_norm_ref` for CPU ones."""
    if x.is_cuda:
        return _rms_norm_triton(x, weight, eps)
    if x.device.type != "cpu":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    return rms_norm_ref(x, weight, eps)


class _RMSNorm(torch.autograd.Function):
    """The JAX `_rms_norm_pallas` custom_vjp: saves (x, weight); the backward
    is `rms_norm_backward` (B11's backward kernel), which skips dw when the
    weight needs no gradient. The module's functions are looked up at each
    call, so that a caller can swap in plain versions."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, g, ctx.eps, need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis (port of `rms_norm`). CUDA tensors launch the
    Triton kernel; CPU tensors run `rms_norm_ref`. Under autograd it is
    `_RMSNorm`, whose backward is `rms_norm_backward`."""
    if grad_needed(x, weight):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_forward(x, weight, eps)


rms_norm.launches = 0  # kernel launches (CUDA tensors only)


# RMSNorm backward (B11's backward) replaces the Pallas kernel
# `_rms_norm_pallas_bwd` / `_rms_bwd_kernel` (paddlemix_tpu/ops/norms.py):
#   dx = rstd * (g*w - xhat * mean(g*w*xhat)),  dw = sum over rows of g*xhat
# in fp32, dx cast to x's dtype and dw to w's. The TPU kernel carries dw in an
# output block across its sequential grid; on Hopper the programs run in
# parallel and in no order, so dw is two launches without atomics (so the sum
# is deterministic): each program of the first walks a run of rows, writes
# their dx and one fp32 partial dw row, and the second adds the partial rows
# column by column. When the weight needs no gradient (LoRA freezes the
# norms) only dx is made: one program a row, no partials, one launch. Either
# way the kernel reads x and g once and writes dx once: a few flops a byte,
# so it is bound by those bytes.
def rms_norm_backward_ref(x, weight, g, eps: float = 1e-6, need_dw: bool = True):
    """Plain version (port of `_rms_bwd_kernel`): (dx in x's dtype, dw in the
    weight's dtype or None), all in fp32."""
    xf, gf, wf = x.float(), g.float(), weight.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dxhat = gf * wf
    dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype) if need_dw else None
    return dx.to(x.dtype), dw


@functools.lru_cache(maxsize=None)
def _column_sum_kernel():
    """The second pass of the norms' weight gradients (B10, B11): the fp32
    partial rows (n_parts, C) of the first pass summed column by column, in
    a fixed order, into out (C,) in out's dtype."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def column_sum(part_ptr, out_ptr, n_parts, C, BLOCK_P: tl.constexpr,
                   BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            mask = (parts < n_parts)[:, None] & cmask[None, :]
            acc += tl.sum(tl.load(part_ptr + parts.to(tl.int64)[:, None] * C + cols[None, :],
                                  mask=mask, other=0.0), axis=0)
        tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)

    return column_sum


def _column_sum(partial, out):
    """out (C,) = partial (n_parts, C) summed over its rows (`column_sum`)."""
    n_parts, c = partial.shape
    _column_sum_kernel()[(-(-c // 128),)](partial, out, n_parts, c, BLOCK_P=32, BLOCK_C=128,
                                          num_warps=4)


@functools.lru_cache(maxsize=None)
def _rms_bwd_kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, dwp_ptr, rows, H, eps, rows_per_prog,
                     WANT_DW: tl.constexpr, BLOCK_H: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_H], dtype=tl.float32)
        for i in range(0, rows_per_prog):
            row = pid * rows_per_prog + i
            mask = cmask & (row < rows)
            offs = row.to(tl.int64) * H + cols
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            rstd = tl.rsqrt(tl.sum(x * x, axis=0) / H + eps)
            xhat = x * rstd
            dxhat = g * w
            dx = rstd * (dxhat - xhat * (tl.sum(dxhat * xhat, axis=0) / H))
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            if WANT_DW:
                acc += g * xhat
        if WANT_DW:
            tl.store(dwp_ptr + pid.to(tl.int64) * H + cols, acc, mask=cmask)

    return rms_norm_bwd


_RMS_DW_PROGRAMS_PER_SM = 2  # partial dw rows: 2 a multiprocessor (264 on an H100)


def _rms_norm_bwd_triton(x, weight, g, eps, need_dw):
    if not (x.is_contiguous() and g.is_contiguous()) or g.shape != x.shape \
            or g.device != x.device or x.dtype not in (torch.bfloat16, torch.float16,
                                                         torch.float32) \
            or x.shape[-1] > _RMS_MAX_WIDTH:
        raise ValueError(f"rms_norm backward kernel takes contiguous x and g of one shape, "
                         f"bf16/fp16/fp32, at most {_RMS_MAX_WIDTH} wide; got x {x.dtype} "
                         f"{tuple(x.shape)} {x.stride()}, g {g.dtype} {tuple(g.shape)} "
                         f"{g.stride()} on {g.device}")
    h = x.shape[-1]
    if weight.device != x.device or weight.shape != (h,) or not weight.is_contiguous():
        raise ValueError(f"rms_norm backward: weight must be a contiguous ({h},) tensor on "
                         f"{x.device}, got {tuple(weight.shape)} on {weight.device}")
    rows = x.numel() // h
    block = max(128, 1 << (h - 1).bit_length())
    warps = min(16, max(1, block // 512))
    dx = torch.empty_like(x)
    bwd = _rms_bwd_kernels()
    with torch.cuda.device(x.device):
        if not need_dw:
            bwd[(rows,)](x, weight, g, dx, dx, rows, h, float(eps), 1, WANT_DW=False,
                         BLOCK_H=block, num_warps=warps)
            return dx, None
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per_prog = -(-rows // (_RMS_DW_PROGRAMS_PER_SM * sms))
        n_parts = -(-rows // per_prog)
        partial = torch.empty((n_parts, h), dtype=torch.float32, device=x.device)
        dw = torch.empty_like(weight)
        bwd[(n_parts,)](x, weight, g, dx, partial, rows, h, float(eps), per_prog, WANT_DW=True,
                        BLOCK_H=block, num_warps=warps)
        _column_sum(partial, dw)
    return dx, dw


def rms_norm_backward(x, weight, g, eps: float = 1e-6, need_dw: bool = True):
    """(dx, dw or None) of `rms_norm` at (x, weight) for the output gradient g
    (port of `_rms_norm_pallas_bwd`). CUDA tensors launch the Triton kernels
    (one launch without dw, two with); CPU tensors run
    `rms_norm_backward_ref`."""
    if x.is_cuda:
        out = _rms_norm_bwd_triton(x, weight, g.contiguous(), eps, need_dw)
        rms_norm_backward.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"rms_norm backward: unsupported device {x.device}")
    return rms_norm_backward_ref(x, weight, g, eps, need_dw)


rms_norm_backward.launches = 0  # backward calls that launched the kernels (CUDA tensors only)


# ------------------------------------------- adaLN and fused adaLN + residual
# B12 `adaptive_layer_norm` and B13 `fused_adaln_scale_residual` replace the
# Pallas kernels `_adaln_pallas_fwd_impl` / `_adaln_kernel` and
# `_fused_adaln_residual_pallas` / `_fused_adaln_residual_kernel`
# (paddlemix_tpu/ops/norms.py), the modulated norms of the SD3 MM-DiT. Both are
# a LayerNorm without affine over each row of x (B, S, H), in fp32, followed
# by y = LN(.) * (1 + scale[b]) + shift[b]; B13 first forms the gated residual
# resi = residual + gate[b] * x and normalises that fp32 sum before rounding it
# to the `resi` output. They do a few flops a byte, so they are bound by the
# bytes: one program normalises one row (SD3-medium: 1536 wide, 3 KB in bf16)
# in registers, so x (and the residual) are read once and y (and resi) written
# once, in the input dtype; the (B, H) modulation rows, read per program, stay
# in L2. The model's bf16 activations and modulation vectors are read as they
# are and widened in registers: the JAX model casts them to fp32 around its
# Pallas call, which the kernel folds in, so no fp32 copy is made. The JAX
# package sends rows not a multiple of 128 wide, or fewer than 64 rows, to
# XLA, which fuses the norm into its neighbours; eager PyTorch has no such
# fusion, so the port launches the kernel for every call on the card.
_ADALN_MAX_WIDTH = 2048  # one row in one program's registers; SD3-medium's is 1536


def _check_affine(name, weight, bias):
    if weight is not None or bias is not None:
        raise NotImplementedError(f"{name}: the affine weight/bias form is not ported (the "
                                  f"SD3 path never passes it)")


def adaptive_layer_norm_ref(x, scale, shift, weight=None, bias=None, eps: float = 1e-5):
    """Plain version (port of `adaptive_layer_norm_xla`): LN(x) * (1 + scale)
    + shift over x (B, S, H) with scale/shift (B, H), all in fp32, cast to x's
    dtype once, as the JAX model computes it (it casts to fp32 around the op)."""
    _check_affine("adaptive_layer_norm", weight, bias)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]).to(x.dtype)


def fused_adaln_scale_residual_ref(residual, x, gate, scale, shift, weight=None, bias=None,
                                   eps: float = 1e-5):
    """Plain version (port of `fused_adaln_scale_residual_xla`): resi =
    residual + gate * x, y = adaLN(resi); returns (y, resi). The LN is taken
    over the fp32 sum, and both outputs are cast to x's dtype."""
    _check_affine("fused_adaln_scale_residual", weight, bias)
    resi = residual.float() + gate.float()[:, None, :] * x.float()
    return adaptive_layer_norm_ref(resi, scale, shift, eps=eps).to(x.dtype), resi.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _adaln_kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _modulated_ln(r, cols, mask, b, H, eps, scale_ptr, shift_ptr, mod_stride):
        mean = tl.sum(r, axis=0) / H
        diff = tl.where(mask, r - mean, 0.0)
        rstd = tl.rsqrt(tl.sum(diff * diff, axis=0) / H + eps)
        sc = tl.load(scale_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        return diff * rstd * (1.0 + sc) + sh

    @triton.jit
    def adaln_fwd(x_ptr, scale_ptr, shift_ptr, y_ptr, S, H, mod_stride, eps,
                  BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        x = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0).to(tl.float32)
        y = _modulated_ln(x, cols, mask, b, H, eps, scale_ptr, shift_ptr, mod_stride)
        tl.store(y_ptr + row * H + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def fused_adaln_residual_fwd(res_ptr, x_ptr, gate_ptr, scale_ptr, shift_ptr, y_ptr,
                                 resi_ptr, S, H, mod_stride, eps, BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        offs = row * H + cols
        res = tl.load(res_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(gate_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        r = res + g * x
        tl.store(resi_ptr + offs, r.to(resi_ptr.dtype.element_ty), mask=mask)
        y = _modulated_ln(r, cols, mask, b, H, eps, scale_ptr, shift_ptr, mod_stride)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return adaln_fwd, fused_adaln_residual_fwd


def _check_adaln(name, rows, mods):
    """x-like (B, S, H) contiguous bf16 tensors (the SD3 path's dtype; the
    kernel reads and writes nothing else) and (B, H) modulation rows with unit
    column stride and one row stride; returns that stride."""
    x = rows[0]
    if x.ndim != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: x must be (B, S, H) bf16, got {x.dtype} {tuple(x.shape)}")
    b, _, h = x.shape
    if h > _ADALN_MAX_WIDTH:
        raise ValueError(f"{name}: width {h} above {_ADALN_MAX_WIDTH}")
    for t in rows:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    stride = mods[0].stride(0)
    for t in mods:
        if t.shape != (b, h) or t.device != x.device or t.stride() != (stride, 1):
            raise ValueError(f"{name}: scale/shift/gate must be ({b}, {h}) on {x.device} with "
                             f"unit column stride and one row stride, got {tuple(t.shape)} "
                             f"strides {t.stride()} on {t.device}")
    return stride


def _row_launch(h):
    block = max(128, 1 << (h - 1).bit_length())
    return block, min(16, max(1, block // 256))


def adaptive_layer_norm(x, scale, shift, weight=None, bias=None, eps: float = 1e-5):
    """LN(x) * (1 + scale) + shift, x (B, S, H), scale/shift (B, H) (port of
    `adaptive_layer_norm`). CUDA tensors launch the Triton kernel (B12), whose
    backward is autograd of the plain version; CPU tensors run
    `adaptive_layer_norm_ref`. The output has x's dtype."""
    _check_affine("adaptive_layer_norm", weight, bias)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"adaptive_layer_norm: unsupported device {x.device}")
        return adaptive_layer_norm_ref(x, scale, shift, eps=eps)
    stride = _check_adaln("adaptive_layer_norm", (x,), (scale, shift))

    def run(x, scale, shift):
        b, s, h = x.shape
        y = torch.empty_like(x)
        block, warps = _row_launch(h)
        with torch.cuda.device(x.device):
            _adaln_kernels()[0][(b * s,)](x, scale, shift, y, s, h, stride, float(eps),
                                          BLOCK_H=block, num_warps=warps)
        adaptive_layer_norm.launches += 1
        return y
    return with_plain_backward(run, lambda *a: adaptive_layer_norm_ref(*a, eps=eps),
                               x, scale, shift)


adaptive_layer_norm.launches = 0  # kernel launches (CUDA tensors only)


def fused_adaln_scale_residual(residual, x, gate, scale, shift, weight=None, bias=None,
                               eps: float = 1e-5):
    """resi = residual + gate * x; y = LN(resi) * (1 + scale) + shift; returns
    (y, resi) (port of `fused_adaln_scale_residual`). CUDA tensors launch the
    Triton kernel (B13), which writes both in one pass and whose backward is
    autograd of the plain version; CPU tensors run
    `fused_adaln_scale_residual_ref`. Both outputs have x's dtype."""
    _check_affine("fused_adaln_scale_residual", weight, bias)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"fused_adaln_scale_residual: unsupported device {x.device}")
        return fused_adaln_scale_residual_ref(residual, x, gate, scale, shift, eps=eps)
    stride = _check_adaln("fused_adaln_scale_residual", (x, residual), (gate, scale, shift))

    def run(residual, x, gate, scale, shift):
        b, s, h = x.shape
        y, resi = torch.empty_like(x), torch.empty_like(x)
        block, warps = _row_launch(h)
        with torch.cuda.device(x.device):
            _adaln_kernels()[1][(b * s,)](residual, x, gate, scale, shift, y, resi, s, h,
                                          stride, float(eps), BLOCK_H=block, num_warps=warps)
        fused_adaln_scale_residual.launches += 1
        return y, resi
    return with_plain_backward(run, lambda *a: fused_adaln_scale_residual_ref(*a, eps=eps),
                               residual, x, gate, scale, shift)


fused_adaln_scale_residual.launches = 0  # kernel launches (CUDA tensors only)


# ------------------------------------------------------------ LayerNorm (B10)
# `layer_norm` replaces the Pallas kernel `_layer_norm_pallas_fwd_impl` /
# `_ln_fwd_kernel` (paddlemix_tpu/ops/norms.py): per row of x (..., H), the
# fp32 mean, the two-pass variance mean((x - mean)^2), (x - mean) *
# rsqrt(var + eps) * w + b in fp32, rounded once to x's dtype. Under autograd
# it is `_LayerNorm` (the JAX `_layer_norm_pallas` custom_vjp), whose
# backward `layer_norm_backward` replaces `_layer_norm_pallas_bwd` /
# `_ln_bwd_kernel`: dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat *
# xhat)) with dxhat = g * w, dw = sum of g * xhat and db = sum of g over the
# rows, in fp32; dx in x's dtype, dw and db in w's. A program takes a tile of
# rows (a row's H at most _LN_MAX_WIDTH in registers), so x (and g) are read
# once and y (dx) written once: a few flops a byte, bound by those bytes. The
# TPU kernel carries dw and db across its sequential grid; on Hopper the
# programs run in parallel and in no order, so, as in B11's backward, each
# program of the first launch walks a run of row tiles and writes one fp32
# partial row of dw and db, and the shared column sum adds them (no atomics,
# deterministic). The JAX package sends widths not a multiple of 128, fewer
# than 64 rows or a missing w or b to XLA; those are v5e tiling choices, and
# eager PyTorch has no fusion to keep, so on the card every call launches.
_LN_MAX_WIDTH = 1280  # the widest row a path gives it (CLIP-bigG's text tower)
_LN_TILE = 4096  # elements of a row tile: BLOCK_R rows x BLOCK_H columns
_LN_PROGRAMS_PER_SM = 2  # partial dw/db rows of the backward: 2 a multiprocessor


def layer_norm_ref(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain version (copy of `layer_norm_xla`): fp32 mean and two-pass
    variance, (x - mean) * rsqrt(var + eps) * w + b in fp32, cast to x's
    dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_backward_ref(x, weight, g, eps: float = 1e-5):
    """Plain version (port of `_ln_bwd_kernel`): (dx in x's dtype, dw and db
    in the weight's dtype), all in fp32."""
    xf, gf, wf = x.float(), g.float(), weight.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mu) * rstd
    dxhat = gf * wf
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    h = x.shape[-1]
    dw = (gf * xhat).reshape(-1, h).sum(0).to(weight.dtype)
    db = gf.reshape(-1, h).sum(0).to(weight.dtype)
    return dx.to(x.dtype), dw, db


@functools.lru_cache(maxsize=None)
def _ln_kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _tile_stats(x, mask, H, eps):
        """fp32 (x - mean) masked to the row, and rsqrt(two-pass var + eps)."""
        mean = tl.sum(x, axis=1) / H
        diff = tl.where(mask, x - mean[:, None], 0.0)
        return diff, tl.rsqrt(tl.sum(diff * diff, axis=1) / H + eps)

    @triton.jit
    def layer_norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, rows, H, x_stride, eps,
                       BLOCK_R: tl.constexpr, BLOCK_H: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        mask = (r < rows)[:, None] & cmask[None, :]
        r64 = r.to(tl.int64)[:, None]
        x = tl.load(x_ptr + r64 * x_stride + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        diff, rstd = _tile_stats(x, mask, H, eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = diff * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(y_ptr + r64 * H + cols[None, :], y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def layer_norm_bwd(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, rows, H, x_stride, g_stride, eps,
                       rows_per_prog, BLOCK_R: tl.constexpr, BLOCK_H: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc_w = tl.zeros([BLOCK_R, BLOCK_H], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_R, BLOCK_H], dtype=tl.float32)
        for r0 in range(0, rows_per_prog, BLOCK_R):
            r = pid * rows_per_prog + r0 + tl.arange(0, BLOCK_R)
            mask = (r < rows)[:, None] & cmask[None, :]
            r64 = r.to(tl.int64)[:, None]
            x = tl.load(x_ptr + r64 * x_stride + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            g = tl.load(g_ptr + r64 * g_stride + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            diff, rstd = _tile_stats(x, mask, H, eps)
            xhat = diff * rstd[:, None]
            dxhat = g * w[None, :]
            dx = rstd[:, None] * (dxhat - (tl.sum(dxhat, axis=1) / H)[:, None]
                                  - xhat * (tl.sum(dxhat * xhat, axis=1) / H)[:, None])
            tl.store(dx_ptr + r64 * H + cols[None, :], dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc_w += g * xhat
            acc_b += g
        # the program's partial row: dw in columns [0, H), db in [H, 2H)
        out = part_ptr + pid.to(tl.int64) * 2 * H + cols
        tl.store(out, tl.sum(acc_w, axis=0), mask=cmask)
        tl.store(out + H, tl.sum(acc_b, axis=0), mask=cmask)

    return layer_norm_fwd, layer_norm_bwd


def _ln_rows(t, h):
    """t (..., h) as rows of unit column stride: (the 2-D view or a
    contiguous copy, its row stride)."""
    t2 = t.reshape(-1, h)
    if t2.stride(1) != 1:
        t2 = t2.contiguous()
    return t2, t2.stride(0)


def _ln_check(name, x, params):
    h = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32) or h > _LN_MAX_WIDTH:
        raise ValueError(f"{name} kernel takes bf16/fp32 rows at most {_LN_MAX_WIDTH} wide, "
                         f"got {x.dtype} {tuple(x.shape)}")
    for p in params:
        if p.device != x.device or p.shape != (h,) or not p.is_contiguous():
            raise ValueError(f"{name}: weight and bias must be contiguous ({h},) tensors on "
                             f"{x.device}, got {tuple(p.shape)} on {p.device}")


def _ln_tile(h):
    block_h = max(128, 1 << (h - 1).bit_length())
    return max(1, _LN_TILE // block_h), block_h


def _layer_norm_triton(x, weight, bias, eps):
    _ln_check("layer_norm", x, (weight, bias))
    h = x.shape[-1]
    x2, x_stride = _ln_rows(x, h)
    rows = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    block_r, block_h = _ln_tile(h)
    with torch.cuda.device(x.device):
        _ln_kernels()[0][(-(-rows // block_r),)](x2, weight, bias, y, rows, h, x_stride,
                                                 float(eps), BLOCK_R=block_r, BLOCK_H=block_h,
                                                 num_warps=4)
    layer_norm.launches += 1
    return y


def _ln_forward(x, weight, bias, eps):
    """The forward: the kernel for CUDA tensors, `layer_norm_ref` for CPU ones."""
    if x.is_cuda:
        return _layer_norm_triton(x, weight, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    return layer_norm_ref(x, weight, bias, eps)


class _LayerNorm(torch.autograd.Function):
    """The JAX `_layer_norm_pallas` custom_vjp: saves (x, weight); the
    backward is `layer_norm_backward` (B10's backward kernel). The module's
    functions are looked up at each call, so that a caller can swap in plain
    versions."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _ln_forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x, weight, g, ctx.eps)
        needs = ctx.needs_input_grad
        return dx if needs[0] else None, dw if needs[1] else None, db if needs[2] else None, None


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with weight and bias (port of
    `layer_norm`). CUDA tensors launch the Triton kernel (B10); CPU tensors
    run `layer_norm_ref`. The output has x's dtype; weight and bias are read
    as fp32 whatever their dtype. Under autograd it is `_LayerNorm`, whose
    backward is `layer_norm_backward`."""
    if weight is None or bias is None:
        raise NotImplementedError("layer_norm: the form without weight or bias is not ported "
                                  "(no path of the port calls it)")
    if grad_needed(x, weight, bias):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _ln_forward(x, weight, bias, eps)


layer_norm.launches = 0  # kernel launches (CUDA tensors only)


def _ln_bwd_split(rows: int, h: int, sms: int):
    """(programs, rows a program) of the backward's first launch: at most
    _LN_PROGRAMS_PER_SM programs a multiprocessor, each a run of whole row
    tiles; each program writes one partial row of dw and db."""
    block_r = _ln_tile(h)[0]
    n_parts = min(_cdiv(rows, block_r), _LN_PROGRAMS_PER_SM * sms)
    per_prog = _cdiv(_cdiv(rows, n_parts), block_r) * block_r
    return _cdiv(rows, per_prog), per_prog


def _layer_norm_bwd_triton(x, weight, g, eps):
    _ln_check("layer_norm backward", x, (weight,))
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"layer_norm backward: g {tuple(g.shape)} on {g.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    h = x.shape[-1]
    x2, x_stride = _ln_rows(x, h)
    g2, g_stride = _ln_rows(g, h)
    rows = x2.shape[0]
    block_r, block_h = _ln_tile(h)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_parts, per_prog = _ln_bwd_split(rows, h, sms)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    partial = torch.empty((n_parts, 2 * h), dtype=torch.float32, device=x.device)
    dwdb = torch.empty(2 * h, dtype=weight.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _ln_kernels()[1][(n_parts,)](x2, weight, g2, dx, partial, rows, h, x_stride, g_stride,
                                     float(eps), per_prog, BLOCK_R=block_r, BLOCK_H=block_h,
                                     num_warps=8)
        _column_sum(partial, dwdb)
    return dx, dwdb[:h], dwdb[h:]


def layer_norm_backward(x, weight, g, eps: float = 1e-5):
    """(dx, dw, db) of `layer_norm` at (x, weight) for the output gradient g
    (port of `_layer_norm_pallas_bwd`; db does not depend on the bias). CUDA
    tensors launch the Triton kernels (two launches: dx with the partial
    sums, then their column sum); CPU tensors run `layer_norm_backward_ref`."""
    if x.is_cuda:
        out = _layer_norm_bwd_triton(x, weight, g, eps)
        layer_norm_backward.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm backward: unsupported device {x.device}")
    return layer_norm_backward_ref(x, weight, g, eps)


layer_norm_backward.launches = 0  # backward calls that launched the kernels (CUDA tensors only)
