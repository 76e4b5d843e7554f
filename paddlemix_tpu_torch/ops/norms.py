"""GroupNorm (+SiLU) over channel-minor (..., C) tensors, and RMSNorm. Port of
the GroupNorm and RMSNorm parts of paddlemix_tpu/ops/norms.py.

RMSNorm (B11): `rms_norm` launches a Triton kernel for CUDA tensors and runs
its plain version `rms_norm_ref` for CPU tensors. It replaces the forward
Pallas kernel `_rms_norm_pallas_fwd_impl` / `_rms_fwd_kernel`: fp32 mean of
x^2, rsqrt(+eps), times the fp32 weight, cast to x's dtype. One program
normalises one row (Llama-7B: 4096 wide, 8 KB in bf16), so the kernel reads
x once and writes y once: it is bound by those bytes, and a single-row call
(decode) by its launch. The JAX package sends fewer than 64 rows to XLA,
which fuses the norm into its neighbours; eager PyTorch has no such fusion,
and the plain version is about six launches, so the port launches the
kernel for every row count.

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

    CUDA tensors launch the Triton kernel; CPU tensors run `group_norm_ref`."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm act must be 'none' or 'silu', got {act!r}")
    _check_groups(x, groups)
    if x.is_cuda:
        return _group_norm_triton(x, weight, bias, groups, eps, act)
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
        out = _stats_triton(x, groups, eps)
        group_norm_stats.launches += 1
        return out
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


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last axis (port of `rms_norm`, forward). CUDA tensors
    launch the Triton kernel; CPU tensors run `rms_norm_ref`."""
    if x.is_cuda:
        return _rms_norm_triton(x, weight, eps)
    if x.device.type != "cpu":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    return rms_norm_ref(x, weight, eps)


rms_norm.launches = 0  # kernel launches (CUDA tensors only)
