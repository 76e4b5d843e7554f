"""Static-scale a8w8 PTQ (the scale scope and the quantized layers),
weight-only int8, and Llama's dynamic a8w8 / a8w4. Port of the static half of
paddlemix_tpu/ops/quant.py (static_a8w8_scope, static_quant_dot_general,
static_quant_conv_general_dilated), of its weight-only int8 part
(quantize_weights_int8, wint8_matmul) and of its int4 packing
(quantize_weights_int4, unpack_int4), with the dynamic products of
paddlemix_tpu/models/llama/modeling.py MXUDense (the module-level quantizer
is models/llama MXUDense.quantize_); the weight-only int8 and the dynamic
notes are at the end of the module.

PTQ here means int8 activations with one scale per op, recorded once from a
calibration forward, and int8 weights with one scale per output channel.

  - `static_a8w8_scope()` collects each quantized op's activation
    absmax, max |x| over the whole input tensor, in call order, while the
    model runs its plain (unquantized) path.
  - `load_static_scales(modules, raw)` hands a flat list of raw absmax values,
    in call order, to the quantized modules. The JAX package records the same
    list in the same order, so a list it recorded carries over unchanged.

The JAX package consumes its list once per trace: the whole denoise loop is
one traced body, so every step reuses the same scales. Eager PyTorch calls
the UNet once per step, so each scale lives on its module instead, as a
python float (no device sync per op), and every forward reuses it. A module
without a scale runs its plain path, as the JAX ops do outside a scope.

Loading a scale quantizes the module's weight once: the int8 weight and its
fp32 per-channel scales become non-persistent buffers in the layout the
kernels read, and the parameters keep their names (`weight`, `bias`), so the
state dict and `core/convert.py` are unchanged. The JAX package re-quantizes
the weights in every trace and lets XLA hoist the work.

Numerics, as the JAX package: sx = max(raw, 1e-6) / 127; sw = max(|w|max,
1e-8) / 127 per output channel; round half to even, clip to +-127.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, Linear
from .autograd import refuse_grad
from .conv_int8 import (
    conv3x3_weight_layout,
    int8_a8w8_matmul,
    int8_conv2d_plain,
    int8_conv3x3_same,
    quantize_weight_per_cout,
)
from .gemm_tiles import (
    A8W_TILES,
    BK,
    WINT8_TILES,
    a8w4_plan,
    a8w8_dyn_plan,
    max_clusters,
    wint8_plan,
)

_RECORDING: Optional["static_a8w8_scope"] = None


class static_a8w8_scope:
    """``with static_a8w8_scope() as ctx: model(...)`` runs the model on its
    plain path and appends, for each quantized op in call order, the module
    to ``ctx.modules`` and its input's absmax (a 0-dim fp32 tensor) to
    ``ctx.scales``: the JAX scope's "record" mode. Its "apply" mode is
    `load_static_scales`."""

    def __init__(self):
        self.modules: List[nn.Module] = []
        self.scales: List[torch.Tensor] = []

    def __enter__(self):
        global _RECORDING
        self._prev, _RECORDING = _RECORDING, self
        return self

    def __exit__(self, *exc):
        global _RECORDING
        _RECORDING = self._prev
        return False

    def record(self, module: nn.Module, x: torch.Tensor):
        self.modules.append(module)
        self.scales.append(x.detach().float().abs().amax())

    def raw(self) -> List[float]:
        """The recorded absmax values as floats (one device sync)."""
        return torch.stack(self.scales).tolist() if self.scales else []


def static_scale(raw: float) -> float:
    return max(float(raw), 1e-6) / 127.0


class _StaticQuant:
    """The static a8w8 state of one quantized op (mixed into nn.Linear and
    nn.Conv2d). `sx` is None until a scale is loaded."""

    sx: Optional[float] = None

    def _init_quant(self):
        self.sx = None
        for name in ("wq", "sw", "qbias"):
            self.register_buffer(name, None, persistent=False)

    def _kernel_weight(self, wq):
        return wq

    @torch.no_grad()
    def load_scale(self, raw: float):
        """Set sx from a raw absmax and quantize the weight once."""
        self.sx = static_scale(raw)
        wq, self.sw = quantize_weight_per_cout(self.weight)
        self.wq = self._kernel_weight(wq)
        self.qbias = None if self.bias is None else self.bias.detach().float()

    @property
    def quantized(self) -> bool:
        """A scale is loaded and no record scope is active."""
        return self.sx is not None and _RECORDING is None

    def _record(self, x):
        if _RECORDING is not None:
            _RECORDING.record(self, x)


class QuantLinear(_StaticQuant, nn.Linear):
    """nn.Linear with a static a8w8 path: the int8 GEMM (B2)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()

    def forward(self, x):
        self._record(x)
        if not self.quantized:
            return super().forward(x)
        return int8_a8w8_matmul(x, self.wq, self.sw, self.sx, self.qbias)


def conv_route(kernel_size, stride, padding) -> str:
    """The op (by wrapper name) a conv of this geometry runs under a8w8: a
    1x1 conv is the int8 GEMM over the channels_last (B*H*W, C) view, a 3x3
    stride-1 SAME conv the int8 conv kernel, any other the plain int8 conv."""
    geometry = (tuple(kernel_size), tuple(stride), tuple(padding))
    if geometry == ((1, 1), (1, 1), (0, 0)):
        return "int8_a8w8_matmul"
    if geometry == ((3, 3), (1, 1), (1, 1)):
        return "int8_conv3x3_same"
    return "int8_conv2d_plain"


class QuantConv2d(_StaticQuant, nn.Conv2d):
    """nn.Conv2d over NCHW channels_last maps with a static a8w8 path routed
    by `conv_route`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1, 1) or self.padding_mode != "zeros":
            raise NotImplementedError("QuantConv2d: grouped, dilated or non-zero-padded convs")
        self.route = conv_route(self.kernel_size, self.stride, self.padding)
        self._init_quant()

    def _kernel_weight(self, wq):
        if self.route == "int8_a8w8_matmul":
            return wq.reshape(wq.shape[0], -1).contiguous()   # (O, C)
        if self.route == "int8_conv3x3_same":
            return conv3x3_weight_layout(wq)                  # (O, 3, 3, C)
        return wq

    def forward(self, x):
        self._record(x)
        if not self.quantized:
            return super().forward(x)
        if self.route == "int8_conv2d_plain":
            return int8_conv2d_plain(x, self.wq, self.sw, self.sx, self.qbias,
                                     stride=self.stride[0], padding=self.padding[0])
        nhwc = x.permute(0, 2, 3, 1).contiguous()  # a view of channels_last memory
        if self.route == "int8_a8w8_matmul":
            y = int8_a8w8_matmul(nhwc, self.wq, self.sw, self.sx, self.qbias)
        else:
            y = int8_conv3x3_same(nhwc, self.wq, self.sw, self.sx, self.qbias)
        return y.permute(0, 3, 1, 2)


def linear(quant: bool, *args, **kwargs) -> nn.Linear:
    """A static a8w8 Linear, else one that computes in its `compute_dtype`."""
    return (QuantLinear if quant else Linear)(*args, **kwargs)


def conv2d(quant: bool, *args, **kwargs) -> nn.Conv2d:
    """A static a8w8 conv, else one that computes in its `compute_dtype`."""
    return (QuantConv2d if quant else Conv2d)(*args, **kwargs)


def quant_modules(model: nn.Module) -> List[_StaticQuant]:
    """The quantized ops of `model`, in module (not call) order."""
    return [m for m in model.modules() if isinstance(m, _StaticQuant)]


def load_static_scales(modules: Sequence[_StaticQuant], raw: Sequence[float]):
    """Give each module, in call order, its raw absmax (see the module note)."""
    raw = [float(r) for r in raw]
    if len(raw) != len(modules):
        raise ValueError(f"load_static_scales: {len(raw)} scales for {len(modules)} "
                         f"quantized ops")
    for m, r in zip(modules, raw):
        m.load_scale(r)


# ------------------------------------------------------- weight-only int8
# Llama's projections under quant="wint8" (the reference deploy's
# weight_only_int8): bf16 activations times int8 weights with one fp32 scale
# per output column, summed in fp32, as the JAX package's Pallas kernel does
# (x cast to bf16, the int8 tile widened to bf16, fp32 accumulation, x scale).
# The weight is kept (N, K), K-contiguous per output column (nn.Linear's
# layout); the JAX package keeps the flax kernel's (K, N).
#
# `wint8_matmul` launches `csrc/wint8_gemm.cu` (B6: a GEMV at M = 1, else the
# wgmma core of `csrc/gemm_wg.cuh` at the tile plan of `ops/gemm_tiles.py`)
# for CUDA tensors and runs `wint8_matmul_ref` for CPU tensors.

def quantize_weights_int8(w):
    """w: (N, K), one row per output column -> (int8 (N, K), (N,) fp32
    scales). Port of `quantize_weights_int8` (which takes the (K, N) flax
    kernel): scale = absmax / 127 per output column, 1.0 for an all-zero
    column; w / scale rounded half to even and clipped to +-127. Not B2's
    quantizer (`quantize_weight_per_cout`: max(absmax, 1e-8) and a multiply
    by the reciprocal)."""
    wf = w.detach().float()
    absmax = wf.abs().amax(dim=1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    wq = torch.round(wf / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return wq, scale


def wint8_matmul_ref(x, wq, scale):
    """Plain version: x (..., K), wq (N, K) int8, scale (N,) fp32 -> (..., N)
    in x's dtype, = (bf16(x) @ wq^T) * scale with fp32 sums. Every product
    of a bf16 value and an int8 value is exact in fp32 (and in TF32, whose
    10-bit significand holds both), so only the order of the sums differs
    from the kernel. x is rounded to bf16 first, as both JAX paths do."""
    k, n = x.shape[-1], wq.shape[0]
    xb = x.reshape(-1, k).to(torch.bfloat16).float()
    out = (xb @ wq.float().t()) * scale.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def wint8_matmul_tiled_ref(x, wq, scale, plan=None):
    """The plain version, on the CPU, walked as B6's tiled path walks it at
    `plan` (by default `wint8_plan` on an H100; M > 1): per tile the swapped
    product out^T = Wq x^T of 128 weight rows by the plan's tokens, fp32 sums
    stage by stage over 64-deep K blocks of zero-padded operands (TMA's zero
    fill), scaled per weight row, transposed and stored clipped to (M, N). It
    differs from `wint8_matmul_ref` by the order of the fp32 sums only."""
    k, n = x.shape[-1], wq.shape[0]
    xb = x.reshape(-1, k).to(torch.bfloat16).float()
    plan = plan or wint8_plan(xb.shape[0], n, k)
    kp = plan.k_blocks * BK
    xb = F.pad(xb, (0, kp - k, 0, plan.inner_tiles * plan.tile - xb.shape[0]))
    wp = F.pad(wq.float(), (0, kp - k, 0, plan.outer_tiles * 128 - n))
    sc = F.pad(scale.float(), (0, wp.shape[0] - n))
    out = torch.empty((plan.m, n), dtype=torch.float32)
    for block in plan.walk():
        for outer, inner in block:
            if not plan.in_range(outer, inner):
                continue
            w_rows = slice(outer * 128, outer * 128 + 128)
            tokens = slice(inner * plan.tile, (inner + 1) * plan.tile)
            acc = torch.zeros((128, plan.tile), dtype=torch.float32)
            for kb in range(plan.k_blocks):
                ks = slice(kb * BK, (kb + 1) * BK)
                acc += wp[w_rows, ks] @ xb[tokens, ks].t()
            r, c = plan.region(outer, inner)
            out[r, c] = (acc * sc[w_rows, None]).t()[:r.stop - r.start, :c.stop - c.start]
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


@functools.lru_cache(maxsize=None)
def _wint8_lib():
    from ..kernels import load_library

    lib = load_library("wint8_gemm")
    lib.wint8_gemm_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.wint8_gemm_bf16.restype = ctypes.c_int
    lib.wint8_gemm_smem.argtypes = [ctypes.c_int]
    lib.wint8_gemm_smem.restype = ctypes.c_int
    return lib


def wint8_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of a B6 tiled block at a token tile of `tile`."""
    return _wint8_lib().wint8_gemm_smem(tile)


def wint8_kernel_takes(m: int, k: int, n: int) -> bool:
    """The shapes B6 takes: 16-byte rows of x and wq, column pairs and
    8-column chunks in the epilogue, row tiles within the grid."""
    return k % 16 == 0 and n % 8 == 0 and 0 < -(-m // 128) <= 65535


def _wint8_cuda(x, wq, scale, tiles=WINT8_TILES):
    k, n = x.shape[-1], wq.shape[0]
    m = x.numel() // k
    for name, t, dtype, shape in (("wq", wq, torch.int8, (n, k)),
                                  ("scale", scale, torch.float32, (n,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wint8_matmul: {name} must be a contiguous, 16-byte aligned "
                             f"{dtype} {shape} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16 \
            or not wint8_kernel_takes(m, k, n):
        raise ValueError(f"wint8_matmul kernel takes a contiguous, 16-byte aligned bf16 x "
                         f"with K % 16 == 0 and N % 8 == 0, got {x.dtype} {tuple(x.shape)} "
                         f"(strides {x.stride()}) and N = {n}")
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    plan = None if m == 1 else wint8_plan(
        m, n, k, max_clusters("wint8_gemm", "wint8_gemm_max_clusters", WINT8_TILES,
                              x.device.index), tiles)
    with torch.cuda.device(x.device):
        err = _wint8_lib().wint8_gemm_bf16(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
            0 if plan is None else plan.tile, 0 if plan is None else plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"wint8_gemm_bf16 launch failed with cudaError {err}")
    wint8_matmul.launches += 1
    return out


def wint8_matmul(x, wq, scale):
    """Weight-only int8 matmul (port of `wint8_matmul`): x (..., K) @ wq
    (N, K) int8, x scale (N,) -> (..., N) in x's dtype. CUDA tensors launch
    the kernel; CPU tensors run `wint8_matmul_ref`."""
    if x.is_cuda:
        refuse_grad("wint8_matmul", x, scale)
        return _wint8_cuda(x, wq, scale)
    if x.device.type != "cpu":
        raise ValueError(f"wint8_matmul: unsupported device {x.device}")
    return wint8_matmul_ref(x, wq, scale)


wint8_matmul.launches = 0  # kernel launches (CUDA tensors only)


# ------------------------------------------------------ dynamic a8w8 / a8w4
# Llama's projections under quant="a8w8", "a8w4" or "wint4" (the JAX
# MXUDense's dynamic branches; wint4 takes a8w4's): each row of x is quantized
# to int8 at run time with its own scale, the weights are int8 (N, K) or int4
# packed two to a byte (N, K // 2), each output column has one fp32 scale, and
# the int32 sum is scaled by the row's and the column's scales. The weights
# keep nn.Linear's (out, in) layout: the transpose of the flax kernel_q, whose
# int4 packing splits the input halves (row k of w in the low nibble of byte
# k, row k + K / 2 in the high one), which a transpose keeps.
#
# `a8w8_matmul` / `a8w4_matmul` launch csrc/a8w_gemm.cu (N1 / N2: a GEMV at
# M = 1, else an activation pass and the wgmma core at the tile plan of
# ops/gemm_tiles.py) for CUDA tensors and run `a8w8_matmul_ref` /
# `a8w4_matmul_ref` for CPU tensors.

A8W_GEMV_MAX_K = 48128  # the GEMV keeps x's int8 row in shared memory


def quantize_weights_int4(w):
    """w: (N, K), one row per output column, K even -> (kernel_q int8 (N,
    K // 2), (N,) fp32 scales). Port of `quantize_weights_int4` (which takes
    the (K, N) flax kernel): symmetric int4, scale = absmax / 7 per output
    column (1.0 for an all-zero column), w / scale rounded half to even and
    clipped to +-7; column k of the row goes in the low nibble of byte k,
    column k + K / 2 in its high nibble."""
    wf = w.detach().float()
    k = wf.shape[1]
    if k % 2:
        raise ValueError(f"quantize_weights_int4: the int4 pack needs an even input width, got {k}")
    absmax = wf.abs().amax(dim=1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.round(wf / scale[:, None]).clamp_(-7, 7).to(torch.int32)
    packed = (q[:, k // 2:] << 4) | (q[:, :k // 2] & 15)
    return packed.to(torch.int8), scale


def unpack_int4(packed):
    """(N, K // 2) packed int8 -> (N, K) int8: the low nibbles, then the high
    ones, each sign-extended by arithmetic shifts (port of `unpack_int4`)."""
    p = packed.to(torch.int32)
    return torch.cat([(p << 28) >> 28, (p << 24) >> 28], dim=1).to(torch.int8)


def quantize_rows_int8(x):
    """x (..., K) -> (xq int8 (..., K), sx fp32 (...,)): JAX's dynamic per-row
    activation quantizer. sx = max(|x|max, 1e-6) / 127, the max taken in x's
    dtype; xq = clip(round_half_even(x / sx), -127, 127). Both divisions are
    tensor by tensor, so that they divide on the card too (PyTorch computes
    `t / 127.0` there as t * (1 / 127))."""
    amax = x.abs().amax(dim=-1).float().clamp(min=1e-6)
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.round(x.float() / sx[..., None]).clamp_(-127, 127).to(torch.int8)
    return xq, sx


def _a8w_product(x, wq, scale):
    """(float(xq @ wq^T) * sx) * scale, in x's dtype, for x (..., K) and an
    int8 wq (N, K). The int32 sum of JAX's dot is exact in fp64 (|sum| <= 127^2
    K < 2^53), and fp64 -> fp32 rounds an integer to nearest as int32 -> fp32
    does."""
    k, n = x.shape[-1], wq.shape[0]
    xq, sx = quantize_rows_int8(x.reshape(-1, k))
    acc = (xq.double() @ wq.double().t()).float()
    out = (acc * sx[:, None]) * scale.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def a8w8_matmul_ref(x, wq, scale):
    """Plain version of N1: x (..., K) @ wq (N, K) int8 under per-row dynamic
    int8 activations -> (..., N) in x's dtype, JAX's MXUDense a8w8 op for op:
    x / sx, an exact int32 sum, its fp32 rounding, * sx, * scale, one cast."""
    return _a8w_product(x, wq, scale)


def a8w4_matmul_ref(x, wq4, scale):
    """Plain version of N2: as `a8w8_matmul_ref` with the packed int4 weight
    wq4 (N, K // 2), unpacked first."""
    return _a8w_product(x, unpack_int4(wq4), scale)


@functools.lru_cache(maxsize=None)
def _a8w_lib():
    from ..kernels import load_library

    lib = load_library("a8w_gemm")
    for fn in (lib.a8w8_gemm_bf16, lib.a8w4_gemm_bf16):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.a8w_quantize_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.a8w_quantize_rows.restype = ctypes.c_int
    lib.a8w_gemm_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.a8w_gemm_plan.restype = ctypes.c_int
    return lib


_A8W_PLAN = {"a8w8": a8w8_dyn_plan, "a8w4": a8w4_plan}


def a8w_kernel_takes(kind: str, m: int, k: int, n: int) -> bool:
    """The shapes N1 ("a8w8") and N2 ("a8w4") take: 16-byte rows of x and of
    the weight (N2's packed rows are K / 2 bytes), column pairs and 8-column
    chunks in the epilogue, and at M = 1 x's int8 row within the GEMV's shared
    memory."""
    return k % (32 if kind == "a8w4" else 16) == 0 and n % 8 == 0 and m >= 1 \
        and (m > 1 or k <= A8W_GEMV_MAX_K)


def a8w_tile_plan(kind: str, m: int, n: int, k: int, index: int, tiles=None):
    """The tile plan N1 / N2's tiled path runs at (m > 1, k, n) on CUDA
    device `index` (None at m = 1: the GEMV)."""
    if m == 1:
        return None
    clusters = max_clusters("a8w_gemm", f"{kind}_gemm_max_clusters", A8W_TILES, index)
    return _A8W_PLAN[kind](m, n, k, clusters, tiles or A8W_TILES)


def a8w_library_plan(kind: str, m: int, n: int, k: int, tile: int):
    """What the library answers for its tiled path (`a8w_gemm_plan`):
    (unit_inner, units, k_blocks, pair_inner, stages, shared memory), which
    `gemm_tiles.a8w_plan_fields` mirrors."""
    out = (ctypes.c_int * 6)()
    if _a8w_lib().a8w_gemm_plan(0 if kind == "a8w8" else 1, m, n, k, tile, out):
        raise ValueError(f"a8w_gemm_plan: tile {tile} is not compiled")
    return tuple(out)


def quantize_rows_int8_cuda(x):
    """The activation pass alone on the card (x (M, K) bf16, contiguous,
    16-byte aligned, K % 8 == 0): bit for bit `quantize_rows_int8`."""
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16 \
            or x.shape[1] % 8:
        raise ValueError(f"quantize_rows_int8_cuda takes a contiguous, 16-byte aligned bf16 "
                         f"(M, K) with K % 8 == 0, got {x.dtype} {tuple(x.shape)}")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _a8w_lib().a8w_quantize_rows(x.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                                           x.shape[0], x.shape[1],
                                           torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"a8w_quantize_rows launch failed with cudaError {err}")
    return xq, sx


def _a8w_cuda(kind, x, wq, scale, tiles=None):
    name, packed = f"{kind}_matmul", kind == "a8w4"
    k, n = x.shape[-1], wq.shape[0]
    m = x.numel() // k
    wk = k // 2 if packed else k
    for what, t, dtype, shape in (("wq", wq, torch.int8, (n, wk)),
                                  ("scale", scale, torch.float32, (n,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned {dtype} "
                             f"{shape} tensor on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16 \
            or not a8w_kernel_takes(kind, m, k, n):
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte aligned bf16 x with K % "
                         f"{32 if packed else 16} == 0 (K <= {A8W_GEMV_MAX_K} at one row) and "
                         f"N % 8 == 0, got {x.dtype} {tuple(x.shape)} (strides {x.stride()}) "
                         f"and N = {n}")
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    plan = a8w_tile_plan(kind, m, n, k, x.device.index, tiles)
    xq = sx = None
    if plan is not None:  # the activation pass's scratch
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        sx = torch.empty(m, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_a8w_lib(), f"{kind}_gemm_bf16")(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if xq is None else xq.data_ptr(), None if sx is None else sx.data_ptr(),
            m, n, k, 0 if plan is None else plan.tile, 0 if plan is None else plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{kind}_gemm_bf16 launch failed with cudaError {err}")
    return out


def a8w8_matmul(x, wq, scale):
    """Dynamic a8w8 matmul (N1; JAX MXUDense quant="a8w8"): x (..., K) @ wq
    (N, K) int8 with x quantized per row at run time -> (..., N) in x's dtype.
    CUDA tensors launch the kernel (at M > 1 its activation pass and the tiled
    GEMM, one count); CPU tensors run `a8w8_matmul_ref`."""
    if x.is_cuda:
        refuse_grad("a8w8_matmul", x, scale)
        out = _a8w_cuda("a8w8", x, wq, scale)
        a8w8_matmul.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"a8w8_matmul: unsupported device {x.device}")
    return a8w8_matmul_ref(x, wq, scale)


def a8w4_matmul(x, wq4, scale):
    """Dynamic a8w4 matmul (N2; JAX MXUDense quant="a8w4" and "wint4"): as
    `a8w8_matmul` with the packed int4 weight wq4 (N, K // 2), which the
    kernel reads packed. CPU tensors run `a8w4_matmul_ref`."""
    if x.is_cuda:
        refuse_grad("a8w4_matmul", x, scale)
        out = _a8w_cuda("a8w4", x, wq4, scale)
        a8w4_matmul.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"a8w4_matmul: unsupported device {x.device}")
    return a8w4_matmul_ref(x, wq4, scale)


a8w8_matmul.launches = 0  # kernel launches (CUDA tensors only)
a8w4_matmul.launches = 0
