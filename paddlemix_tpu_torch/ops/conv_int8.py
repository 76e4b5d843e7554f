"""int8 a8w8 matmul and 3x3 SAME conv of the static-PTQ path. Port of
paddlemix_tpu/ops/conv_int8.py.

Activations are quantized with one static scale per op (sx = absmax / 127,
recorded once, see ops/quant.py), weights per output channel; both sides are
int8, products are summed exactly in int32, and the dequant (x sx * sw[o]) and
the bias run in fp32 in the epilogue.

`int8_a8w8_matmul` launches `csrc/int8_gemm.cu` (B2) and `int8_conv3x3_same`
launches `csrc/int8_conv3x3.cu` (B3) for CUDA tensors; CPU tensors run the
plain versions `*_ref`. The weights come in already quantized (the port
quantizes them once, when the scales are loaded), in the layouts the kernels
read:
  - matmul: wq (N, K) int8, K-contiguous per output column (nn.Linear's layout);
  - 3x3 conv: wq (O, 3, 3, C) int8, so that row o is (tap, channel)-major,
    tap = 3 * dh + dw, which is the K = 9 * C order of the implicit GEMM.

Rounding is half to even and values clip to +-127, as jnp.round/jnp.clip.

Plain versions and the int8 trap: `int8 @ int8` in PyTorch returns int8 and
overflows silently, so on the CPU they sum int32 products (int32 matmul and
conv2d exist there). On the card they multiply fp32 tensors that hold int8
values: every product is exact (also under TF32, whose 11-bit significand
holds any int8), and the fp32 sums stay exact while below 2**24.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .autograd import refuse_grad

_MAX_GRID_Y = 65535  # row tiles of 128 go on gridDim.y


def quantize_int8(x, sx: float):
    """round_half_even(x / sx) clipped to +-127, as int8; the multiply is by
    the fp32 reciprocal 1/sx, as the JAX kernels do."""
    return torch.round(x.float() * (1.0 / sx)).clamp_(-127, 127).to(torch.int8)


def quantize_weight_per_cout(w):
    """w: (O, ...) -> (int8 (O, ...), (O,) fp32 scales), per output channel:
    sw = max(|w|max, 1e-8) / 127. The port keeps torch's O-first layout; the
    JAX twin reduces over all but the last axis of its (..., O) kernels."""
    wf = w.detach().float()
    wmax = wf.abs().amax(dim=tuple(range(1, w.ndim)))
    sw = wmax.clamp(min=1e-8) / 127.0
    wq = torch.round(wf * (1.0 / sw).view(-1, *(1,) * (w.ndim - 1))).clamp_(-127, 127)
    return wq.to(torch.int8), sw


def _int_matmul(aq, bq_t):
    """Exact (M, K) int8 @ (K, N) int8 -> fp32 (see the module note)."""
    if aq.is_cuda:
        return aq.float() @ bq_t.float()
    return (aq.int() @ bq_t.int()).float()


def _int_conv2d(xq, wq, stride: int, padding: int):
    """Exact NCHW int8 conv -> fp32 (see the module note)."""
    if xq.is_cuda:
        return F.conv2d(xq.float(), wq.float(), stride=stride, padding=padding)
    return F.conv2d(xq.int(), wq.int(), stride=stride, padding=padding).float()


def _dequant(acc, sw, sx: float, bias):
    out = acc * (sw * sx)
    return out + bias.float() if bias is not None else out


# ------------------------------------------------------------ a8w8 matmul
def int8_a8w8_matmul_ref(x, wq, sw, sx: float, bias=None):
    """Plain version: x (..., K) fp, wq (N, K) int8, sw (N,), static sx ->
    (..., N) in x.dtype."""
    acc = _int_matmul(quantize_int8(x.reshape(-1, x.shape[-1]), sx), wq.t())
    return _dequant(acc, sw, sx, bias).to(x.dtype).reshape(*x.shape[:-1], wq.shape[0])


@functools.lru_cache(maxsize=None)
def _gemm_fn():
    from ..kernels import load_library

    fn = load_library("int8_gemm").int8_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operand(fn, name, t, device, dtype, shape):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} (strides {t.stride()})")


def _check_scales(fn, device, n, sw, bias):
    _check_operand(fn, "sw", sw, device, torch.float32, (n,))
    if bias is not None:
        _check_operand(fn, "bias", bias, device, torch.float32, (n,))


def gemm_kernel_takes(m: int, k: int, n: int) -> bool:
    """The shapes B2 takes: 16-byte rows of x and wq, 8-column output chunks."""
    return k % 16 == 0 and n % 8 == 0 and -(-m // 128) <= _MAX_GRID_Y


def conv3x3_kernel_takes(b: int, h: int, w: int, c: int, o: int) -> bool:
    """The shapes B3 and B5 take: 16-channel loads that never straddle a tap."""
    return c % 16 == 0 and o % 8 == 0 and -(-(b * h * w) // 128) <= _MAX_GRID_Y


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _int8_gemm_cuda(x, wq, sw, sx, bias):
    k = x.shape[-1]
    n = wq.shape[0]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    _check_operand("int8_a8w8_matmul", "x", x2, x.device, torch.bfloat16, (m, k))
    _check_operand("int8_a8w8_matmul", "wq", wq, x.device, torch.int8, (n, k))
    bias = None if bias is None else bias.float()
    _check_scales("int8_a8w8_matmul", x.device, n, sw, bias)
    if not gemm_kernel_takes(m, k, n):
        raise ValueError(f"int8_a8w8_matmul kernel takes K % 16 == 0, N % 8 == 0 and "
                         f"M <= {128 * _MAX_GRID_Y}, got M={m} K={k} N={n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _gemm_fn()(x2.data_ptr(), wq.data_ptr(), sw.data_ptr(),
                         0 if bias is None else bias.data_ptr(), out.data_ptr(),
                         m, n, k, float(sx), 1.0 / sx, stream)
    _raise_on(err, "int8_gemm_bf16")
    int8_a8w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


def int8_a8w8_matmul(x, wq, sw, sx: float, bias: Optional[torch.Tensor] = None):
    """x (..., K) @ int8 wq (N, K)^T with static activation scale sx:
    bf16(sx * sw[n] * sum_k q(x[m, k]) * wq[n, k] + bias[n]) (port of
    `int8_a8w8_matmul`). CUDA tensors launch the B2 kernel (bf16 x, fp32
    sw/bias); CPU tensors run `int8_a8w8_matmul_ref`."""
    if x.is_cuda:
        refuse_grad("int8_a8w8_matmul", x, sw, bias)
        return _int8_gemm_cuda(x, wq, sw, sx, bias)
    if x.device.type != "cpu":
        raise ValueError(f"int8_a8w8_matmul: unsupported device {x.device}")
    return int8_a8w8_matmul_ref(x, wq, sw, sx, bias)


int8_a8w8_matmul.launches = 0  # kernel launches (CUDA tensors only)


# ------------------------------------------------------------- conv 3x3 s1
def conv3x3_weight_layout(wq):
    """(O, C, 3, 3) torch conv weight -> (O, 3, 3, C), the kernels' layout."""
    return wq.permute(0, 2, 3, 1).contiguous()


def int8_conv3x3_ref(xq, wq, sw, sx: float, bias=None):
    """int8 NHWC xq (B, H, W, C) conv wq (O, 3, 3, C), SAME padding with int8
    zeros -> fp32 (B, H, W, O) = acc * sx * sw + bias."""
    acc = _int_conv2d(xq.permute(0, 3, 1, 2), wq.permute(0, 3, 1, 2), 1, 1)
    return _dequant(acc.permute(0, 2, 3, 1), sw, sx, bias)


def int8_conv3x3_same_ref(x, wq, sw, sx: float, bias=None):
    """Plain version: x (B, H, W, C) NHWC fp -> (B, H, W, O) in x.dtype."""
    return int8_conv3x3_ref(quantize_int8(x, sx), wq, sw, sx, bias).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _conv_lib():
    from ..kernels import load_library

    lib = load_library("int8_conv3x3")
    lib.int8_conv3x3_bf16.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.fused_gn_silu_conv3x3_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    for fn in (lib.int8_conv3x3_bf16, lib.fused_gn_silu_conv3x3_bf16):
        fn.restype = ctypes.c_int
    return lib


def check_conv3x3_operands(fn, x, wq, sw, bias):
    """Shared wrapper checks of B3 and B5: NHWC bf16 x, (O, 3, 3, C) int8 wq."""
    if x.ndim != 4:
        raise ValueError(f"{fn}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    o = wq.shape[0]
    _check_operand(fn, "x", x, x.device, torch.bfloat16, (b, h, w, c))
    _check_operand(fn, "wq", wq, x.device, torch.int8, (o, 3, 3, c))
    _check_scales(fn, x.device, o, sw, bias)
    if not conv3x3_kernel_takes(b, h, w, c, o):
        raise ValueError(f"{fn} kernel takes C % 16 == 0, O % 8 == 0 and B*H*W <= "
                         f"{128 * _MAX_GRID_Y}, got x {tuple(x.shape)} O={o}")
    return b, h, w, c, o


def _int8_conv3x3_cuda(x, wq, sw, sx, bias):
    bias = None if bias is None else bias.float()
    b, h, w, c, o = check_conv3x3_operands("int8_conv3x3_same", x, wq, sw, bias)
    out = torch.empty((b, h, w, o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _conv_lib().int8_conv3x3_bf16(
            x.data_ptr(), wq.data_ptr(), sw.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), b, h, w, c, o, float(sx), 1.0 / sx, stream)
    _raise_on(err, "int8_conv3x3_bf16")
    int8_conv3x3_same.launches += 1
    return out


def int8_conv3x3_same(x, wq, sw, sx: float, bias: Optional[torch.Tensor] = None):
    """3x3 stride-1 SAME conv of NHWC x (B, H, W, C) with int8 wq (O, 3, 3, C)
    and static activation scale sx -> (B, H, W, O) (port of
    `int8_conv3x3_same`, plus the conv bias in the epilogue). CUDA tensors
    launch the B3 kernel; CPU tensors run `int8_conv3x3_same_ref`."""
    if x.is_cuda:
        refuse_grad("int8_conv3x3_same", x, sw, bias)
        return _int8_conv3x3_cuda(x, wq, sw, sx, bias)
    if x.device.type != "cpu":
        raise ValueError(f"int8_conv3x3_same: unsupported device {x.device}")
    return int8_conv3x3_same_ref(x, wq, sw, sx, bias)


int8_conv3x3_same.launches = 0  # kernel launches (CUDA tensors only)


# ------------------------------------------------------ any other int8 conv
def int8_conv2d_plain(x, wq, sw, sx: float, bias=None, stride: int = 1, padding: int = 0):
    """int8 conv of an NCHW x with wq (O, C, kh, kw), outside any kernel (the
    stride-2 down-sample conv, which the JAX package also leaves to XLA).
    Returns NCHW in x.dtype. Counted in `calls`, on both devices."""
    acc = _int_conv2d(quantize_int8(x, sx), wq, stride, padding)
    out = acc * (sw * sx).view(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1)
    int8_conv2d_plain.calls += 1
    return out.to(x.dtype)


int8_conv2d_plain.calls = 0
