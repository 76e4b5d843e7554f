"""GroupNorm (+SiLU) over channel-minor (..., C) tensors, RMSNorm, the adaLN
pair of the SD3 MM-DiT (adaptive LayerNorm, and adaptive LayerNorm fused with
the gated residual add) and LayerNorm with its backward (B10; see their
sections below). Port of paddlemix_tpu/ops/norms.py.

RMSNorm (B11): `rms_norm` launches csrc/norms.cu's kernel for CUDA tensors
and runs its plain version `rms_norm_ref` for CPU tensors. It replaces the
forward Pallas kernel `_rms_norm_pallas_fwd_impl` / `_rms_fwd_kernel`: fp32
mean of x^2, rsqrt(+eps), times the fp32 weight, cast to x's dtype. A block
takes a row across its threads (Llama-7B: 4096 wide, 8 KB in bf16) with the
weight held in registers, so the kernel reads x once and writes y once: it
is bound by those bytes, and a single-row call (decode) by its launch and
one memory round trip. The JAX package sends fewer than 64 rows to XLA,
which fuses the norm into its neighbours; eager PyTorch has no such fusion,
and the plain version is about six launches, so the port launches the
kernel for every row count. Under autograd `rms_norm` is `_RMSNorm` (the JAX
custom_vjp), whose backward `rms_norm_backward` is a Triton kernel (see its
section below).

GroupNorm (B4), adaLN (B12) and fused adaLN + residual (B13) take their
backward, as the JAX package takes it from XLA, from autograd of their plain
versions, recomputed (`ops.autograd.with_plain_backward`).

`group_norm` launches the CUDA kernels of csrc/norms.cu for CUDA tensors and
runs its plain version `group_norm_ref` for CPU tensors. `group_norm_stats`
launches the statistics kernel alone: the per-(batch, group) mean and rstd
that the fused GroupNorm+SiLU+int8-conv path turns into its affine.

The kernels replace the Pallas kernel `_group_norm_pallas_impl` / `_gn_kernel`
(paddlemix_tpu/ops/norms.py), whose sequential grid carried per-channel sums
from step to step. On Hopper a thread-block cluster owns one (batch, slab of
whole groups) pair and reduces its sums through distributed shared memory, so
a call is one launch where the slab fits in the cluster's shared memory (the
"resident" form: x read once) and two elsewhere (statistics, then an apply
that reads x again); `group_norm_plan` mirrors the library's plan (see
csrc/norms.cu). Any shape with C % groups == 0 is taken, in bf16, fp16 or
fp32, with weight and bias of one float dtype read as fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, fields

import torch

from .autograd import grad_needed, with_plain_backward

_SMS = 132  # an H100 SXM's multiprocessors: the plans' target, as the library's
_MAX_CLUSTER = 16  # Hopper's largest (non-portable) cluster
# dtype codes of the library's C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


# ------------------------------------------------------- GroupNorm's plan
# A mirror of csrc/norms.cu's `gn_plan` (the library answers the same plan
# through `group_norm_plan_library`; chip_smoke.py holds the two equal, and a
# launch whose plan differs from the library's own is refused). A cluster of
# `cluster` blocks owns one (batch, slab) pair: `slab` channels of whole
# groups, a row of them a multiple of 16 bytes (and at least 64 where the
# groups allow). Block `rank` of it holds (resident form) or walks
# (statistics) rows [rank * rows, (rank + 1) * rows) of the slab.
GN_SLAB_BYTES = 64           # a slab's row at least (where the groups allow)
GN_TARGET_BLOCKS = 2 * _SMS  # blocks the cluster size aims at
GN_MIN_ROWS = 32             # rows a block at least
GN_TILE_MAX = 200 * 1024     # a resident tile's bytes at most (+ the sums' scratch)
GN_THREADS = 256             # resident and apply blocks
GN_STATS_THREADS = 512       # statistics blocks
GN_UNROLL = 8                # rows in flight a thread (statistics, apply)
GN_BOX_ROWS = 256            # TMA's largest box
GN_HEAD = 512                # mbarriers: one a box
RESIDENT, REREAD = 0, 1      # the plan's forms: one launch, or statistics + apply
# Clusters of the resident kernel (256 threads) that an H100 SXM runs at once,
# by cluster size 1, 2, 4, 8, 16 and a block's shared memory up to 30, 60,
# 100 KB or more (cudaOccupancyMaxActiveClusters; `norms_max_clusters`)
GN_CAPACITY = ((528, 396, 264, 132), (264, 198, 132, 66), (124, 92, 62, 30), (62, 45, 30, 15),
               (28, 21, 14, 7))
GN_STATS_CAPACITY = (264, 132, 62, 30, 14)  # the statistics kernel's (512 threads)


def _gn_capacity(cl: int, smem: int) -> int:
    col = 0 if smem <= 30 * 1024 else 1 if smem <= 60 * 1024 else 2 if smem <= 100 * 1024 else 3
    return GN_CAPACITY[(cl - 1).bit_length()][col]


@dataclass(frozen=True)
class GnPlan:
    form: int           # RESIDENT or REREAD
    slab: int           # channels a cluster owns
    vec: int            # elements a load: 16 bytes, or 1
    cluster: int        # blocks a cluster
    rows: int           # rows a block holds (resident) or walks (statistics)
    threads: int        # threads a resident or statistics block
    box: int            # rows of a TMA box (resident)
    smem: int           # dynamic shared memory a resident or statistics block
    apply_rows: int     # rows a block of the apply kernel (re-read form)
    apply_span: int     # its columns: whole slabs, whole rows where they fit

    def ints(self):
        return tuple(getattr(self, f.name) for f in fields(self))

    def launches(self, stats: bool = False) -> int:
        """Kernel launches of a call: the statistics alone one; GroupNorm one
        (resident) or two (statistics, then the apply)."""
        return 1 if stats or self.form == RESIDENT else 2

    def tile_bytes(self, esize: int) -> int:
        return _cdiv(self.rows, self.box) * self.box * self.slab * esize if self.box else 0

    def blocks(self, b: int, n: int, c: int):
        """(batch, first channel, cluster rank, first row, end row) of every
        block of the resident or statistics launch, in block order (rows
        clipped to n; a block past the rows holds none)."""
        out = []
        for cid in range(b * (c // self.slab)):
            bb, sl = divmod(cid, c // self.slab)
            for rank in range(self.cluster):
                lo = min(n, rank * self.rows)
                out.append((bb, sl * self.slab, rank, lo, min(n, lo + self.rows)))
        return out


def _gn_slab(c: int, groups: int, esize: int) -> int:
    cpg = c // groups
    s16 = 0
    for k in range(1, groups + 1):
        if groups % k:
            continue
        s = cpg * k
        if s * esize % 16 == 0:
            if s * esize >= GN_SLAB_BYTES:
                return s
            s16 = s
    if s16:
        return s16
    return next((cpg * k for k in range(1, groups + 1)
                 if groups % k == 0 and cpg * k * esize >= GN_SLAB_BYTES), c)


def _gn_smem(tile: int, threads: int, slab: int, cpg: int) -> int:
    """GN_HEAD bytes of mbarriers, the tile, each warp's channel sums and the
    slab's group sums, totals, means and rstds."""
    return GN_HEAD + tile + 4 * (threads // 32 * 2 * slab + 6 * (slab // cpg))


def group_norm_plan(b: int, n: int, c: int, groups: int, esize: int, aligned: bool = True,
                    stats: bool = False):
    """The plan of a (b, n rows, c) map in `groups` groups, `esize` bytes an
    element (x 16-byte aligned if `aligned`), for GroupNorm or, with `stats`,
    its statistics alone; None where no plan takes the shape (a slab of more
    than GN_STATS_THREADS / 2 loads)."""
    if b < 1 or n < 1 or groups < 1 or c % groups:
        return None
    slab = _gn_slab(c, groups, esize)
    vec = 16 // esize if aligned and slab * esize % 16 == 0 else 1
    nv = slab // vec
    if nv > GN_STATS_THREADS // 2:
        return None
    cpg = c // groups
    clusters = b * (c // slab)
    most = _cdiv(n, GN_MIN_ROWS) if n < GN_MIN_ROWS * _MAX_CLUSTER else _MAX_CLUSTER
    spread = _cdiv(GN_TARGET_BLOCKS, clusters)
    top = 1
    while top * 2 <= most and top < spread:
        top *= 2
    span = max(slab * k for k in range(1, c // slab + 1)
               if (c // slab) % k == 0 and (k == 1 or slab * k // vec <= GN_THREADS))
    apply = dict(apply_rows=GN_THREADS // (span // vec) * GN_UNROLL, apply_span=span)
    if not stats and vec > 1 and slab <= GN_BOX_ROWS:
        cl = top
        while cl >= 1:
            rows = _cdiv(n, cl)
            box = (rows + 7) // 8 * 8 if rows < GN_BOX_ROWS else GN_BOX_ROWS
            tile = _cdiv(rows, box) * box * slab * esize
            smem = _gn_smem(tile, GN_THREADS, slab, cpg)
            if tile <= GN_TILE_MAX and clusters <= _gn_capacity(cl, smem):
                return GnPlan(RESIDENT, slab, vec, cl, rows, GN_THREADS, box, smem, **apply)
            cl //= 2
    cl = top  # the statistics: the largest cluster whose clusters all run at once
    while cl > 1 and clusters > GN_STATS_CAPACITY[(cl - 1).bit_length()]:
        cl //= 2
    return GnPlan(REREAD, slab, vec, cl, _cdiv(n, cl), GN_STATS_THREADS, 0,
                  _gn_smem(0, GN_STATS_THREADS, slab, cpg), **apply)


def _plan_array(plan):
    vals = plan.ints()
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _norms_lib():
    from ..kernels import load_library

    lib = load_library("norms")
    lib.group_norm_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.layer_norm_bwd_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.group_norm_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    lib.layer_norm_bwd_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_float] + [ctypes.c_void_p] * 2
    lib.norms_max_clusters.argtypes = [ctypes.c_int] * 4
    lib.rms_norm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.rms_norm_cuda.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.adaln_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.adaln_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fused_adaln_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fused_adaln_cuda.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.layer_norm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.layer_norm_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p]
    lib.norms_empty_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.group_norm_plan, lib.layer_norm_bwd_plan, lib.group_norm_cuda,
               lib.layer_norm_bwd_cuda, lib.norms_max_clusters, lib.rms_norm_plan,
               lib.rms_norm_cuda, lib.adaln_plan, lib.adaln_cuda, lib.fused_adaln_plan,
               lib.fused_adaln_cuda, lib.layer_norm_plan, lib.layer_norm_cuda,
               lib.norms_empty_launch):
        fn.restype = ctypes.c_int
    return lib


def group_norm_plan_library(b: int, n: int, c: int, groups: int, dtype, aligned: bool = True,
                            stats: bool = False):
    """The library's own GroupNorm plan (csrc/norms.cu `group_norm_plan`),
    which `group_norm_plan` mirrors; None where it takes no plan."""
    out = (ctypes.c_int * len(fields(GnPlan)))()
    if _norms_lib().group_norm_plan(b, n, c, groups, _DTYPE_CODE[dtype], int(aligned),
                                    int(stats), out) != 0:
        return None
    return GnPlan(*out)


def norms_max_clusters(kind: int, threads: int, smem: int, cluster: int) -> int:
    """Clusters of a launch shape that the card runs at once
    (cudaOccupancyMaxActiveClusters): kind 0 GroupNorm's resident kernel, 1
    its statistics kernel, 2 the LayerNorm backward, 3 its wide form; -1 if
    the query fails."""
    return _norms_lib().norms_max_clusters(kind, threads, smem, cluster)


def _raw_stream(device: int) -> int:
    """The handle of `device`'s current CUDA stream (what Triton's launcher
    reads too): a kernel of the library launches on it."""
    return torch._C._cuda_getCurrentRawStream(device)


def empty_launch(blocks: int, threads: int, count: int = 1):
    """`count` launches of an empty kernel of `blocks` x `threads` on the
    current device's current stream: the floor under a kernel of that launch
    shape."""
    dev = torch.cuda.current_device()
    _check_launch("empty kernel", _norms_lib().norms_empty_launch(blocks, threads, count, dev,
                                                                  _raw_stream(dev)))


def _check_launch(name, err):
    if err == 20000:
        raise RuntimeError(f"{name}: the plan passed is not the library's own (the mirror in "
                           f"ops/norms.py and csrc/norms.cu disagree)")
    if err >= 10000:
        raise RuntimeError(f"{name}: libcuda refused a tensor map (CUresult {err - 10000})")
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _check_input(x, weight, bias):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm kernel takes bf16/fp16/fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"group_norm kernel needs a contiguous channel-minor tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.device != x.device or p.shape != (c,) or not p.is_contiguous()
                              or p.dtype not in _DTYPE_CODE or p.dtype != weight.dtype):
            raise ValueError(f"group_norm: {name} must be a contiguous ({c},) float tensor on "
                             f"{x.device} of the weight's dtype, got {tuple(p.shape)} "
                             f"{p.dtype} on {p.device}")


def _gn_plan_of(x, groups, stats):
    b, c, n = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    plan = group_norm_plan(b, n, c, groups, x.element_size(), x.data_ptr() % 16 == 0, stats)
    if plan is None:
        raise ValueError(f"group_norm kernel: no plan takes {tuple(x.shape)} in {groups} groups "
                         f"({x.dtype}): a slab of whole groups wider than "
                         f"{GN_STATS_THREADS // 2} loads")
    return plan, b, n, c


def _group_norm_cuda(x, weight, bias, groups, eps, act, stats=False):
    """GroupNorm (+ SiLU) of x into a new tensor, or with `stats` the
    (mean, rstd) pair alone, through the library."""
    _check_input(x, weight, bias)
    if x.numel() == 0 and not stats:
        return torch.empty_like(x)
    plan, b, n, c = _gn_plan_of(x, groups, stats)
    y = None if stats else torch.empty_like(x)
    mean = rstd = None
    if stats or plan.form == REREAD:
        mean, rstd = torch.empty((2, b, groups), dtype=torch.float32, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(x.device):
        err = _norms_lib().group_norm_cuda(
            x.data_ptr(), ptr(weight), ptr(bias), _DTYPE_CODE[(weight if weight is not None
                                                                else x).dtype],
            ptr(y), ptr(mean), ptr(rstd), _DTYPE_CODE[x.dtype], b, n, c, groups, float(eps),
            int(act == "silu"), _plan_array(plan), torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("group_norm_stats" if stats else "group_norm", err)
    return (mean, rstd) if stats else y


def _check_groups(x, groups):
    if x.ndim < 2 or x.shape[-1] % groups:
        raise ValueError(f"group_norm: channels {tuple(x.shape)[-1:]} not divisible by "
                         f"groups {groups} (shape {tuple(x.shape)})")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"group_norm: unsupported device {x.device}")


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5, act: str = "none"):
    """GroupNorm over (B, ..., C) with optional fused SiLU (port of `group_norm`).

    CUDA tensors launch the kernels of csrc/norms.cu (one launch, or two
    where `group_norm_plan` takes the re-read form), whose backward is
    autograd of the plain version; CPU tensors run `group_norm_ref`."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm act must be 'none' or 'silu', got {act!r}")
    _check_groups(x, groups)
    if x.is_cuda:
        def run(x_, w_, b_):
            y = _group_norm_cuda(x_, w_, b_, groups, eps, act)
            group_norm.launches += 1
            return y
        return with_plain_backward(
            run, lambda x_, w_, b_: group_norm_ref(x_, w_, b_, groups, eps, act), x, weight, bias)
    return group_norm_ref(x, weight, bias, groups, eps, act)


group_norm.launches = 0  # wrapper calls that launched the kernels (CUDA tensors only)


def group_norm_stats(x, groups: int, eps: float = 1e-5):
    """Per-(batch, group) fp32 (mean, rsqrt(var + eps)) of (B, ..., C), each
    (B, groups): the kernel's statistics alone, which the fused
    GroupNorm+SiLU+int8-conv path (ops/fused_resnet.py) turns into its affine.
    CUDA tensors launch the statistics kernel; CPU tensors run the plain
    moments."""
    _check_groups(x, groups)
    if x.is_cuda:
        def run(x_):
            out = _group_norm_cuda(x_, None, None, groups, eps, "none", stats=True)
            group_norm_stats.launches += 1
            return out
        return with_plain_backward(run, lambda x_: _group_moments(x_, groups, eps), x)
    return _group_moments(x, groups, eps)


group_norm_stats.launches = 0  # statistics launches (CUDA tensors only)


# ---------------------------------------------------------------- RMSNorm
# B11's forward is csrc/norms.cu's `rms_norm_fwd_kernel`; `rms_norm_plan`
# mirrors its plan (the library answers it through `rms_norm_plan_library`,
# and a launch whose plan is not the library's own is refused). A block takes
# a row at a time across all its threads, `cpt` chunks a thread (chunk c =
# tid + k threads, 16 bytes of x where x, y and the weight are 16-byte aligned
# and the row a multiple of 16 bytes, else one element), the weight held in
# registers for all of its rows. Up to 132 x (1,024 // threads) rows a block
# each (a block a row: the decode row, T5's 77); above, that many blocks, each
# a run of rows, the next row in flight in registers while one reduces.
_RMS_MAX_WIDTH = 16384  # 1,024 threads of 16 elements
RMS_THREADS = 256          # a block's threads where the row's chunks allow
RMS_MAX_CPT = 16           # chunks a thread at most
RMS_THREADS_PER_SM = 1024  # the grid's blocks an SM, in threads


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """Plain version (port of `rms_norm_xla`): x * rsqrt(mean(x^2) + eps) * w,
    all in fp32, cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


@dataclass(frozen=True)
class RmsPlan:
    vec: int      # elements a chunk: 16 bytes of x, or 1
    cpt: int      # chunks a thread: 1, 2, 4, 8 or 16
    threads: int  # threads a block
    rpb: int      # rows a block, one after another
    blocks: int

    def ints(self):
        return tuple(getattr(self, f.name) for f in fields(self))

    def block_rows(self, block: int, rows: int) -> range:
        return range(min(rows, block * self.rpb), min(rows, (block + 1) * self.rpb))

    def thread_columns(self, tid: int, h: int):
        """The columns of a row that thread `tid` holds, in its order."""
        nvec = h // self.vec
        return [c * self.vec + e for k in range(self.cpt) for c in (tid + k * self.threads,)
                if c < nvec for e in range(self.vec)]


def rms_norm_plan(rows: int, h: int, esize: int, aligned: bool = True):
    """The RMSNorm forward's plan at (rows, h), `esize` bytes an element of x;
    `aligned`: x, y and the weight start 16-byte aligned. None where no plan
    takes the shape."""
    if rows < 1 or not 1 <= h <= _RMS_MAX_WIDTH:
        return None
    vec = 16 // esize if aligned and h * esize % 16 == 0 else 1
    nvec = h // vec
    cpt = 1
    while cpt < RMS_MAX_CPT and cpt * RMS_THREADS < nvec:
        cpt *= 2
    threads = (_cdiv(nvec, cpt) + 31) // 32 * 32
    rpb = _cdiv(rows, _SMS * max(1, RMS_THREADS_PER_SM // threads))
    return RmsPlan(vec, cpt, threads, rpb, _cdiv(rows, rpb))


def rms_norm_plan_library(rows: int, h: int, dtype, aligned: bool = True):
    """The library's own plan (csrc/norms.cu `rms_norm_plan`), which
    `rms_norm_plan` mirrors; None where it takes no plan."""
    out = (ctypes.c_int * len(fields(RmsPlan)))()
    if _norms_lib().rms_norm_plan(rows, h, _DTYPE_CODE[dtype], int(aligned), out) != 0:
        return None
    return RmsPlan(*out)


@functools.lru_cache(maxsize=1024)
def _rms_launch_plan(rows, h, esize, aligned):
    plan = rms_norm_plan(rows, h, esize, aligned)
    return plan, None if plan is None else _plan_array(plan)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rms_norm_plan_of(x, weight, y=None):
    """The plan the kernel takes for x (..., h) and its weight (and y, where
    given; the wrapper's own output is allocated 16-byte aligned)."""
    h = x.shape[-1]
    return _rms_launch_plan(x.numel() // h, h, x.element_size(),
                            _aligned(x, weight, *(() if y is None else (y,))))[0]


def _rms_check(x, weight):
    """The kernel's inputs: x contiguous bf16 / fp16 / fp32 at most
    _RMS_MAX_WIDTH wide; the weight a contiguous (h,) tensor on x's device.
    Returns the weight as the kernel reads it (fp32 where its dtype is no
    float of the kernel's)."""
    h = x.shape[-1] if x.ndim else 0
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous() or not 1 <= h <= _RMS_MAX_WIDTH:
        raise ValueError(f"rms_norm kernel takes a contiguous bf16/fp16/fp32 tensor 1 to "
                         f"{_RMS_MAX_WIDTH} wide, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if weight.device != x.device or weight.shape != (h,) or not weight.is_contiguous():
        raise ValueError(f"rms_norm: weight must be a contiguous ({h},) tensor on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")
    return weight if weight.dtype in _DTYPE_CODE else weight.float()


def _rms_norm_cuda(x, weight, eps):
    """y = RMSNorm(x) through csrc/norms.cu's kernel, one launch."""
    weight = _rms_check(x, weight)
    y = torch.empty_like(x)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return y
    _, arr = _rms_launch_plan(rows, h, x.element_size(), _aligned(x, weight, y))
    dev = x.get_device()
    err = _norms_lib().rms_norm_cuda(
        x.data_ptr(), weight.data_ptr(), _DTYPE_CODE[weight.dtype], y.data_ptr(),
        _DTYPE_CODE[x.dtype], rows, h, float(eps), arr, dev, _raw_stream(dev))
    _check_launch("rms_norm", err)
    rms_norm.launches += 1
    return y


def _rms_forward(x, weight, eps):
    """The forward: the kernel for CUDA tensors, `rms_norm_ref` for CPU ones."""
    if x.is_cuda:
        return _rms_norm_cuda(x, weight, eps)
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
    """RMSNorm over the last axis (port of `rms_norm`). CUDA tensors launch
    csrc/norms.cu's kernel (one launch); CPU tensors run `rms_norm_ref`. Under
    autograd it is `_RMSNorm`, whose backward is `rms_norm_backward`."""
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
# bytes: x (and the residual) are read once and y (and resi) written once, in
# the input dtype. The model's bf16 activations and modulation vectors are
# read as they are and widened in registers: the JAX model casts them to fp32
# around its Pallas call, which the kernels fold in, so no fp32 copy is made.
# B12 is csrc/norms.cu's `adaln_warp_kernel` (many rows: a warp a row, a
# block's rows a run within one batch element, 1 + scale[b] and shift[b] held
# in registers for all of them) and `adaln_row_kernel` (few rows: a block a
# row); `adaln_plan` mirrors its plan. B13 is `fused_adaln_residual_row_kernel`
# (a block a row, SD3's 308 context and 8,192 image rows alike: every load of
# the row and of the modulation rows issued first, resi stored as soon as it
# is formed, the moments two-pass over the block), of the family it shares
# with LayerNorm's forward; `fused_adaln_plan` mirrors its plan. The
# JAX package sends rows not a multiple of 128 wide, or fewer than 64 rows, to
# XLA, which fuses the norm into its neighbours; eager PyTorch has no such
# fusion, so the port launches the kernel for every call on the card.
_ADALN_MAX_WIDTH = 2048  # the widest row a warp holds (8 chunks a lane); SD3-medium's is 1536
# adaLN's plan, a mirror of csrc/norms.cu's `ada_plan` (`adaln_plan_library`).
# The 16-byte form needs x, y, scale and shift 16-byte aligned, the modulation
# row strides multiples of 16 bytes and the row a multiple of 8; else one
# element a load. Many rows (above ADALN_ROW_BLOCKS an SM) in the 16-byte
# form: the warp form, a warp a row at a time, a block of ADALN_WARPS warps an
# SM taking a run of rows of one batch element, interleaved over its warps,
# 1 + scale[b] and shift[b] held in registers, each warp's next row in flight.
# Otherwise (few rows, or the one-element form): the row form, a block a row.
ADALN_WARPS = 8
ADALN_ROW_BLOCKS = 8              # rows an SM that take a block each
ADALN_THREADS = 256               # a row-form block's threads at most
ADALN_LANE_CPT = (1, 2, 4, 6, 8)  # compiled chunks a lane, warp form
ADALN_WARP, ADALN_ROW = 0, 1


@dataclass(frozen=True)
class AdalnPlan:
    form: int     # ADALN_WARP or ADALN_ROW
    vec: int      # elements a chunk: 8 (16 bytes), or 1
    cpt: int      # chunks a lane (warp form) or a thread (row form)
    threads: int  # threads a block
    rpb: int      # rows a block, within one batch element
    nb: int       # blocks a batch element

    def ints(self):
        return tuple(getattr(self, f.name) for f in fields(self))

    def blocks(self, b: int) -> int:
        return b * self.nb

    def warp_rows(self, block: int, warp: int, s: int):
        """(batch element, its rows) that warp `warp` of block `block` takes;
        in the row form the block's one row is every warp's."""
        b, j = divmod(block, self.nb)
        r0 = j * self.rpb
        if self.form == ADALN_ROW:
            return b, range(r0, r0 + 1)
        return b, range(r0 + warp, min(s, r0 + self.rpb), self.threads // 32)

    def thread_columns(self, tid: int, h: int):
        """The columns of a row that thread `tid` (the warp form: lane) holds,
        in its order."""
        nvec = h // self.vec
        span = 32 if self.form == ADALN_WARP else self.threads
        return [c * self.vec + e for k in range(self.cpt) for c in (tid % span + k * span,)
                if c < nvec for e in range(self.vec)]


def adaln_plan(b: int, s: int, h: int, aligned: bool = True):
    """adaLN's plan at x (b, s, h); `aligned`: x, y, scale and shift start
    16-byte aligned and both modulation row strides are multiples of 16
    bytes. None where no plan takes the shape."""
    if b < 1 or s < 1 or not 1 <= h <= _ADALN_MAX_WIDTH:
        return None
    vec = 8 if aligned and h % 8 == 0 else 1
    nvec = h // vec
    if vec > 1 and b * s > _SMS * ADALN_ROW_BLOCKS:
        cpt = next(c for c in ADALN_LANE_CPT if c * 32 >= nvec)
        rpb = _cdiv(s, _SMS // b if b < _SMS else 1)
        return AdalnPlan(ADALN_WARP, vec, cpt, min(rpb, ADALN_WARPS) * 32, rpb, _cdiv(s, rpb))
    cpt = 1
    while cpt * ADALN_THREADS < nvec:
        cpt *= 2
    return AdalnPlan(ADALN_ROW, vec, cpt, (_cdiv(nvec, cpt) + 31) // 32 * 32, 1, s)


def adaln_plan_library(b: int, s: int, h: int, aligned: bool = True):
    """The library's own plan (csrc/norms.cu `adaln_plan`), which `adaln_plan`
    mirrors; None where it takes no plan."""
    out = (ctypes.c_int * len(fields(AdalnPlan)))()
    if _norms_lib().adaln_plan(b, s, h, int(aligned), out) != 0:
        return None
    return AdalnPlan(*out)


@functools.lru_cache(maxsize=1024)
def _adaln_launch_plan(b, s, h, aligned):
    plan = adaln_plan(b, s, h, aligned)
    return plan, None if plan is None else _plan_array(plan)


def _adaln_aligned(x, scale, shift, y):
    ms = scale.element_size()
    return _aligned(x, y, scale, shift) and scale.stride(0) * ms % 16 == 0 \
        and shift.stride(0) * ms % 16 == 0


def adaln_plan_of(x, scale, shift, y=None):
    """The plan the kernel takes for x (B, S, H) and its modulation rows (and
    y, where given; the wrapper's own output is allocated 16-byte aligned)."""
    scale, shift = _adaln_mods(scale, shift)
    return _adaln_launch_plan(*x.shape, _adaln_aligned(x, scale, shift, x if y is None else y))[0]


# B10's forward and B13, one family: a mirror of csrc/norms.cu's `norm_plan`
# (the library answers it through `layer_norm_plan_library` and
# `fused_adaln_plan_library`), of adaLN's fields. The 16-byte form needs every
# row pointer and per-column vector 16-byte aligned and every row stride (x's,
# the modulation rows') and the row a multiple of 16 bytes; else one element a
# load. LayerNorm's many rows (above NORM_ROW_BLOCKS an SM) in the 16-byte
# form, of at most 4 chunks a lane (the CLIP rows): the warp form, a warp a
# row, a block of NORM_WARPS warps on as many rows, as many blocks as the rows
# need (small blocks, so an SM holds many rows in flight). Otherwise (B13's
# rows at any count, the towers' few rows): the row form, a block a row.
# LayerNorm's rows are one batch element's.
OP_LN, OP_FUSED = 0, 1                      # B10's forward, B13
NORM_WARP, NORM_ROW = ADALN_WARP, ADALN_ROW  # a warp a row, or a block a row
NORM_WARPS = 4
NORM_ROW_BLOCKS = 8                     # rows an SM that take a block each
NORM_THREADS = 256                      # a row-form block's threads at most
NORM_LANE_CPT = (1, 2, 3, 4)           # chunks a lane, warp form


def _norm_plan(op: int, b: int, s: int, h: int, esize: int, aligned: bool):
    widest = _ADALN_MAX_WIDTH if op == OP_FUSED else _LN_FWD_MAX_WIDTH
    if b < 1 or s < 1 or not 1 <= h <= widest:
        return None
    vec = 16 // esize if aligned and h * esize % 16 == 0 else 1
    nvec = h // vec
    many = vec > 1 and b * s > _SMS * NORM_ROW_BLOCKS
    lane_cpt = next((c for c in NORM_LANE_CPT if c * 32 >= nvec), 0)
    if many and lane_cpt and op == OP_LN:
        rpb = min(s, NORM_WARPS)
        return AdalnPlan(NORM_WARP, vec, lane_cpt, rpb * 32, rpb, _cdiv(s, rpb))
    cpt = 1
    while cpt * NORM_THREADS < nvec:
        cpt *= 2
    return AdalnPlan(NORM_ROW, vec, cpt, (_cdiv(nvec, cpt) + 31) // 32 * 32, 1, s)


@functools.lru_cache(maxsize=1024)
def _norm_launch_plan(op, b, s, h, esize, aligned):
    plan = _norm_plan(op, b, s, h, esize, aligned)
    return plan, None if plan is None else _plan_array(plan)


def fused_adaln_plan(b: int, s: int, h: int, aligned: bool = True):
    """B13's plan at x (b, s, h) bf16; `aligned`: the residual, x, both
    outputs and the modulation rows start 16-byte aligned and the rows'
    strides are multiples of 16 bytes. None where no plan takes the shape."""
    return _norm_plan(OP_FUSED, b, s, h, 2, aligned)


def layer_norm_plan(rows: int, h: int, esize: int, aligned: bool = True):
    """LayerNorm's forward plan at (rows, h), `esize` bytes an element of x;
    `aligned`: x, y, w and b start 16-byte aligned and x's row stride is a
    multiple of 16 bytes. None where no plan takes the shape."""
    return _norm_plan(OP_LN, 1, rows, h, esize, aligned)


def _library_plan(entry, *args):
    out = (ctypes.c_int * len(fields(AdalnPlan)))()
    if getattr(_norms_lib(), entry)(*args, out) != 0:
        return None
    return AdalnPlan(*out)


def fused_adaln_plan_library(b: int, s: int, h: int, aligned: bool = True):
    """The library's own plan (csrc/norms.cu `fused_adaln_plan`), which
    `fused_adaln_plan` mirrors; None where it takes no plan."""
    return _library_plan("fused_adaln_plan", b, s, h, int(aligned))


def layer_norm_plan_library(rows: int, h: int, dtype, aligned: bool = True):
    """The library's own plan (csrc/norms.cu `layer_norm_plan`), which
    `layer_norm_plan` mirrors; None where it takes no plan."""
    return _library_plan("layer_norm_plan", rows, h, _DTYPE_CODE[dtype], int(aligned))


def _aligned_ptrs(ptrs, strides, esize) -> bool:
    """Pointers 16-byte aligned and row strides (of `esize`-byte elements)
    multiples of 16 bytes."""
    return not any(p % 16 for p in ptrs) and not any(st * esize % 16 for st in strides)


def fused_adaln_plan_of(residual, x, gate, scale, shift, y=None, resi=None):
    """The plan the kernel takes for B13's inputs (and outputs, where given;
    the wrapper's own are allocated 16-byte aligned)."""
    mods = _adaln_mods(gate, scale, shift)
    rows = (residual, x, *mods) + (() if y is None else (y, resi))
    aligned = _aligned_ptrs([t.data_ptr() for t in rows], [m.stride(0) for m in mods],
                            mods[0].element_size())
    return _norm_launch_plan(OP_FUSED, *x.shape, 2, aligned)[0]


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


def _check_adaln(name, rows, mods):
    """x-like (B, S, H) contiguous bf16 tensors (the SD3 path's dtype; the
    kernel reads and writes nothing else) and (B, H) modulation rows with unit
    column stride and one row stride."""
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


def _adaln_mods(*mods):
    """The per-column vectors (modulation rows; LayerNorm's weight and bias)
    as the kernels read them, of one dtype: as they are where all are one
    float dtype of the kernels', else all in fp32 (an exact widening)."""
    if all(m.dtype == mods[0].dtype for m in mods) and mods[0].dtype in _DTYPE_CODE:
        return mods
    return tuple(m.float() for m in mods)


def _adaln_cuda(x, scale, shift, eps):
    """y = adaLN(x) through csrc/norms.cu's kernel, one launch."""
    scale, shift = _adaln_mods(scale, shift)
    b, s, h = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _, arr = _adaln_launch_plan(b, s, h, _adaln_aligned(x, scale, shift, y))
    dev = x.get_device()
    err = _norms_lib().adaln_cuda(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), _DTYPE_CODE[scale.dtype], y.data_ptr(),
        b, s, h, scale.stride(0), shift.stride(0), float(eps), arr, dev, _raw_stream(dev))
    _check_launch("adaptive_layer_norm", err)
    adaptive_layer_norm.launches += 1
    return y


def adaptive_layer_norm(x, scale, shift, weight=None, bias=None, eps: float = 1e-5):
    """LN(x) * (1 + scale) + shift, x (B, S, H), scale/shift (B, H) (port of
    `adaptive_layer_norm`). CUDA tensors launch csrc/norms.cu's kernel (B12,
    one launch), whose backward is autograd of the plain version; CPU tensors
    run `adaptive_layer_norm_ref`. The output has x's dtype."""
    _check_affine("adaptive_layer_norm", weight, bias)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"adaptive_layer_norm: unsupported device {x.device}")
        return adaptive_layer_norm_ref(x, scale, shift, eps=eps)
    _check_adaln("adaptive_layer_norm", (x,), (scale, shift))
    return with_plain_backward(lambda *t: _adaln_cuda(*t, eps),
                               lambda *a: adaptive_layer_norm_ref(*a, eps=eps), x, scale, shift)


adaptive_layer_norm.launches = 0  # kernel launches (CUDA tensors only)


def _fused_adaln_cuda(residual, x, gate, scale, shift, eps):
    """(y, resi) of B13 through csrc/norms.cu's kernel, one launch."""
    mods = _adaln_mods(gate, scale, shift)
    b, s, h = x.shape
    y, resi = torch.empty_like(x), torch.empty_like(x)
    if y.numel() == 0:
        return y, resi
    ptrs = [t.data_ptr() for t in (residual, x, *mods, y, resi)]
    strides = [m.stride(0) for m in mods]
    _, arr = _norm_launch_plan(OP_FUSED, b, s, h, 2,
                               _aligned_ptrs(ptrs, strides, mods[0].element_size()))
    dev = x.get_device()
    err = _norms_lib().fused_adaln_cuda(*ptrs[:5], _DTYPE_CODE[mods[0].dtype], *ptrs[5:], b, s, h,
                                        *strides, float(eps), arr, dev, _raw_stream(dev))
    _check_launch("fused_adaln_scale_residual", err)
    fused_adaln_scale_residual.launches += 1
    return y, resi


def fused_adaln_scale_residual(residual, x, gate, scale, shift, weight=None, bias=None,
                               eps: float = 1e-5):
    """resi = residual + gate * x; y = LN(resi) * (1 + scale) + shift; returns
    (y, resi) (port of `fused_adaln_scale_residual`). CUDA tensors launch
    csrc/norms.cu's kernel (B13, one launch writing both), whose backward is
    autograd of the plain version; CPU tensors run
    `fused_adaln_scale_residual_ref`. Both outputs have x's dtype."""
    _check_affine("fused_adaln_scale_residual", weight, bias)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"fused_adaln_scale_residual: unsupported device {x.device}")
        return fused_adaln_scale_residual_ref(residual, x, gate, scale, shift, eps=eps)
    _check_adaln("fused_adaln_scale_residual", (x, residual), (gate, scale, shift))
    return with_plain_backward(lambda *t: _fused_adaln_cuda(*t, eps),
                               lambda *a: fused_adaln_scale_residual_ref(*a, eps=eps),
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
# rows, in fp32; dx in x's dtype, dw and db in w's. The forward reads x once
# and writes y once: a few flops a byte, bound by those bytes. It is
# csrc/norms.cu's `layer_norm_fwd_warp_kernel` (many rows: a warp a row in
# blocks of a few warps, w and b read after the moments) and
# `layer_norm_fwd_row_kernel` (few rows, the text towers' 77 and LLaVA's 577:
# a block a row, one memory round trip), B13's family;
# `layer_norm_plan` mirrors its plan. x is read in place at its row stride
# (the pooled x[:, 0]). The backward is csrc/norms.cu's CUDA kernel, one
# launch a call: a warp a row at a time with the next rows in flight, dw and db summed
# across the block's warps and then across a thread-block cluster through
# distributed shared memory; with several clusters (above 1,024 rows) the
# last block to finish each slice of the columns adds the clusters' partial
# rows in order (no atomics on the data: deterministic). Rows up to 1,280
# wide are held in registers; wider ones (EVA's 2,048-wide `ffn_ln`) take the
# wide form: dw and db in registers, w in shared memory, the row read from its
# ring slot once a pass, one block an SM. `layer_norm_bwd_plan` mirrors its
# plan. The forward takes rows to 4,096 wide (OPT-2.7B's 2,560, BLIP-2's
# language model: the row form at two 16-byte chunks a thread, 160 threads;
# InternVL2's projector and Qwen-VL's Resampler at 4,096: the same two chunks
# at 256 threads, fp32 four, one element a load sixteen); the backward stops
# at 2,048, the widest row a training path gives it, and refuses wider rows
# with a message (training OPT, InternVL2 or Qwen-VL is not ported). The JAX
# package sends widths not a multiple of 128, fewer than 64 rows or a missing
# w or b to XLA; those are v5e tiling choices, and eager PyTorch has no fusion
# to keep, so on the card every call launches.
_LN_MAX_WIDTH = 2048  # the backward's widest row (EVA's sub-LN `ffn_ln`)
_LN_FWD_MAX_WIDTH = 4096  # the forward's (InternVL2's projector, Qwen-VL's Resampler)


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


def _ln_rows(t, h):
    """t (..., h) as rows of unit column stride: (the 2-D view or a
    contiguous copy, its row stride)."""
    t2 = t.reshape(-1, h)
    if t2.stride(1) != 1:
        t2 = t2.contiguous()
    return t2, t2.stride(0)


def _ln_check(name, x, params, max_width):
    h = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32) or h > max_width:
        raise ValueError(f"{name} kernel takes bf16/fp32 rows at most {max_width} wide, "
                         f"got {x.dtype} {tuple(x.shape)}"
                         + ("" if max_width == _LN_FWD_MAX_WIDTH else
                            f" (the forward takes rows to {_LN_FWD_MAX_WIDTH}; "
                            f"training at that width is not ported)"))
    for p in params:
        if p.device != x.device or p.shape != (h,) or not p.is_contiguous():
            raise ValueError(f"{name}: weight and bias must be contiguous ({h},) tensors on "
                             f"{x.device}, got {tuple(p.shape)} on {p.device}")


def layer_norm_plan_of(x, weight, bias, y=None):
    """The plan the kernel takes for x (..., h) with its weight and bias (and
    y, where given; the wrapper's own is allocated 16-byte aligned)."""
    weight, bias = _adaln_mods(weight, bias)
    h = x.shape[-1]
    x2, xs = _ln_rows(x, h)
    es = x.element_size()
    ptrs = [t.data_ptr() for t in (x2, weight, bias) + (() if y is None else (y,))]
    aligned = _aligned_ptrs(ptrs, [xs], es)
    return _norm_launch_plan(OP_LN, 1, x2.shape[0], h, es, aligned)[0]


def _layer_norm_cuda(x, weight, bias, eps):
    """y = LayerNorm(x) through csrc/norms.cu's kernel, one launch; w and b
    read as fp32 whatever their float dtype."""
    _ln_check("layer_norm", x, (weight, bias), _LN_FWD_MAX_WIDTH)
    weight, bias = _adaln_mods(weight, bias)
    h = x.shape[-1]
    x2, xs = _ln_rows(x, h)
    rows = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    es = x.element_size()
    ptrs = [t.data_ptr() for t in (x2, weight, bias, y)]
    _, arr = _norm_launch_plan(OP_LN, 1, rows, h, es, _aligned_ptrs(ptrs, [xs], es))
    dev = x.get_device()
    err = _norms_lib().layer_norm_cuda(*ptrs[:3], _DTYPE_CODE[weight.dtype], ptrs[3],
                                       _DTYPE_CODE[x.dtype], rows, h, xs, float(eps), arr, dev,
                                       _raw_stream(dev))
    _check_launch("layer_norm", err)
    layer_norm.launches += 1
    return y


def _ln_forward(x, weight, bias, eps):
    """The forward: the kernel for CUDA tensors, `layer_norm_ref` for CPU ones."""
    if x.is_cuda:
        return _layer_norm_cuda(x, weight, bias, eps)
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
    `layer_norm`). CUDA tensors launch csrc/norms.cu's kernel (B10, one
    launch); CPU tensors run `layer_norm_ref`. The output has x's dtype;
    weight and bias are read as fp32 whatever their dtype. Under autograd it
    is `_LayerNorm`, whose backward is `layer_norm_backward`."""
    if weight is None or bias is None:
        raise NotImplementedError("layer_norm: the form without weight or bias is not ported "
                                  "(no path of the port calls it)")
    if grad_needed(x, weight, bias):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _ln_forward(x, weight, bias, eps)


layer_norm.launches = 0  # kernel launches (CUDA tensors only)


# The backward's plan: a mirror of csrc/norms.cu's `ln_plan` (the library
# answers it through `layer_norm_bwd_plan_library`). Warp w of block k takes
# rows [(8 k + w) rpw, (8 k + w + 1) rpw); block k is rank k % cluster of
# cluster k // cluster. Up to LN_SINGLE_ROWS rows one cluster of up to 16
# blocks takes them all; above, LN_BLOCKS blocks in clusters of LN_CLUSTER,
# each cluster one partial row, added in cluster order.
LN_WARPS = 8
LN_RING_BYTES = 96 * 1024   # a block's ring of rows in flight
LN_SINGLE_ROWS = 1024       # rows one cluster takes alone
LN_CLUSTER = 4              # blocks a cluster, several clusters
LN_BLOCKS = 60 * LN_CLUSTER  # two an SM, in the clusters of 4 an H100 SXM runs at once (62)
LN_HOLD_EPL = 40            # a lane's share held in registers at most (rows up to 1,280)
LN_WIDE_EPL = 64            # the wide form's share (2,048 / 32)
LN_WIDE_RING_BYTES = 128 * 1024  # the wide form's ring, one block an SM
LN_WIDE_CLUSTER = 8         # one cluster's blocks at most, wide form
LN_WIDE_BLOCKS = 30 * LN_CLUSTER  # one block an SM: half of LN_BLOCKS' clusters


@dataclass(frozen=True)
class LnBwdPlan:
    vec: int       # elements a load: 16 bytes, or 1
    epl: int       # elements of a row a lane holds
    stages: int    # rows of a warp's ring (0: no ring, one element a load)
    warps: int     # warps a block
    cluster: int   # blocks a cluster
    clusters: int
    rpw: int       # rows a warp
    smem: int      # dynamic shared memory a block

    def ints(self):
        return tuple(getattr(self, f.name) for f in fields(self))

    def warp_rows(self, block: int, warp: int, rows: int) -> range:
        first = (block * self.warps + warp) * self.rpw
        return range(min(rows, first), min(rows, first + self.rpw))

    def cluster_rows(self, q: int, rows: int) -> range:
        """The rows of cluster q, whose sums make its partial row."""
        span = self.cluster * self.warps * self.rpw
        return range(min(rows, q * span), min(rows, (q + 1) * span))


def _ln_row_bytes(h: int, esize: int) -> int:
    return (h * esize + 15) // 16 * 16


def layer_norm_bwd_plan(rows: int, h: int, esize: int, aligned: bool = True):
    """The LayerNorm backward's plan at (rows, h), `esize` bytes an element;
    `aligned`: x, g and dx 16-byte aligned and both row strides multiples of
    16 bytes. None where no plan takes the shape."""
    if not 1 <= h <= _LN_MAX_WIDTH or rows < 1:
        return None
    vec = 16 // esize if aligned and h * esize % 16 == 0 else 1
    row_bytes = _ln_row_bytes(h, esize)
    if vec > 1:
        epl = (_cdiv(h, 32 * vec) * vec + 7) // 8 * 8
        wide = epl > LN_HOLD_EPL
        if wide:
            epl = LN_WIDE_EPL
            stages = min(4, max(1, LN_WIDE_RING_BYTES // (LN_WARPS * 2 * row_bytes)))
        else:
            stages = min(4, max(2, LN_RING_BYTES // (LN_WARPS * 2 * row_bytes)))
    else:
        wide = h > LN_HOLD_EPL * 32
        epl, stages = LN_WIDE_EPL if wide else LN_HOLD_EPL, 0
    if rows <= LN_SINGLE_ROWS:
        cap = LN_WIDE_CLUSTER if wide else _MAX_CLUSTER
        cluster, clusters = min(cap, _cdiv(rows, LN_WARPS)), 1
    else:
        cluster = LN_CLUSTER
        clusters = (LN_WIDE_BLOCKS if wide else LN_BLOCKS) // LN_CLUSTER
    # the ring, then (wide) w in lane order; after the rows each warp's dw / db
    ring = LN_WARPS * stages * 2 * row_bytes + (32 * epl * 4 if wide else 0)
    return LnBwdPlan(vec, epl, stages, LN_WARPS, cluster, clusters,
                     _cdiv(rows, cluster * clusters * LN_WARPS),
                     max(ring, LN_WARPS * 64 * epl * 4))


def layer_norm_bwd_plan_library(rows: int, h: int, dtype, aligned: bool = True):
    """The library's own plan (csrc/norms.cu `layer_norm_bwd_plan`), which
    `layer_norm_bwd_plan` mirrors; None where it takes no plan."""
    out = (ctypes.c_int * len(fields(LnBwdPlan)))()
    if _norms_lib().layer_norm_bwd_plan(rows, h, _DTYPE_CODE[dtype], int(aligned), out) != 0:
        return None
    return LnBwdPlan(*out)


@functools.lru_cache(maxsize=None)
def _tickets(device: torch.device):
    """The backward's tickets on a device: one a cluster rank, 0 between
    launches (each launch leaves them 0)."""
    return torch.zeros(_MAX_CLUSTER, dtype=torch.int32, device=device)


def _layer_norm_bwd_cuda(x, weight, g, eps):
    _ln_check("layer_norm backward", x, (weight,), _LN_MAX_WIDTH)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"layer_norm backward: g {g.dtype} {tuple(g.shape)} on {g.device} does "
                         f"not match x {x.dtype} {tuple(x.shape)} on {x.device}")
    if weight.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer_norm backward: weight must be a float tensor, got {weight.dtype}")
    h = x.shape[-1]
    x2, x_stride = _ln_rows(x, h)
    g2, g_stride = _ln_rows(g, h)
    rows = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dwdb = torch.empty(2 * h, dtype=weight.dtype, device=x.device)
    if rows == 0:
        return dx, dwdb[:h].zero_(), dwdb[h:].zero_()
    es = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, g2, dx)) and \
        x_stride * es % 16 == 0 and g_stride * es % 16 == 0
    plan = layer_norm_bwd_plan(rows, h, es, aligned)
    partial = torch.empty((plan.clusters, 64 * plan.epl), dtype=torch.float32, device=x.device) \
        if plan.clusters > 1 else None
    with torch.cuda.device(x.device):
        err = _norms_lib().layer_norm_bwd_cuda(
            x2.data_ptr(), g2.data_ptr(), weight.data_ptr(), _DTYPE_CODE[weight.dtype],
            dx.data_ptr(), dwdb.data_ptr(), dwdb[h:].data_ptr(),
            None if partial is None else partial.data_ptr(), _tickets(x.device).data_ptr(),
            _DTYPE_CODE[x.dtype], rows, h, x_stride, g_stride, float(eps), _plan_array(plan),
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("layer_norm_backward", err)
    return dx, dwdb[:h], dwdb[h:]


def layer_norm_backward(x, weight, g, eps: float = 1e-5):
    """(dx, dw, db) of `layer_norm` at (x, weight) for the output gradient g
    (port of `_layer_norm_pallas_bwd`; db does not depend on the bias). CUDA
    tensors launch csrc/norms.cu's kernel (one launch); CPU tensors run
    `layer_norm_backward_ref`."""
    if x.is_cuda:
        out = _layer_norm_bwd_cuda(x, weight, g, eps)
        layer_norm_backward.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm backward: unsupported device {x.device}")
    return layer_norm_backward_ref(x, weight, g, eps)


layer_norm_backward.launches = 0  # backward calls that launched the kernels (CUDA tensors only)
