"""Static-scale a8w8 PTQ (the scale scope and the quantized layers) and
weight-only int8. Port of the static half of paddlemix_tpu/ops/quant.py
(static_a8w8_scope, static_quant_dot_general,
static_quant_conv_general_dilated) and of its weight-only int8 part
(quantize_weights_int8, wint8_matmul; the module-level quantizer is
models/llama MXUDense.quantize_wint8_); the weight-only int8 notes are at
the end of the module.

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
# `wint8_matmul` launches `csrc/wint8_gemm.cu` (B6) for CUDA tensors and runs
# `wint8_matmul_ref` for CPU tensors.

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


@functools.lru_cache(maxsize=None)
def _wint8_fn():
    from ..kernels import load_library

    fn = load_library("wint8_gemm").wint8_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wint8_kernel_takes(m: int, k: int, n: int) -> bool:
    """The shapes B6 takes: 16-byte rows of x and wq, column pairs and
    8-column chunks in the epilogue, row tiles within the grid."""
    return k % 16 == 0 and n % 8 == 0 and 0 < -(-m // 128) <= 65535


def _wint8_cuda(x, wq, scale):
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
    with torch.cuda.device(x.device):
        err = _wint8_fn()(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
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
