"""int8 a8w8 matmul and 3x3 SAME conv of the static-PTQ path. Port of
paddlemix_tpu/ops/conv_int8.py.

Activations are quantized with one static scale per op (sx = absmax / 127,
recorded once, see ops/quant.py), weights per output channel; both sides are
int8, products are summed exactly in int32, and the dequant (x sx * sw[o]) and
the bias run in fp32 in the epilogue.

`int8_a8w8_matmul` launches `csrc/int8_gemm.cu` (B2, the wgmma core of
`csrc/gemm_wg.cuh` at the tile plan of `ops/gemm_tiles.py`) and
`int8_conv3x3_same` the two kernels of `csrc/int8_conv3x3.cu` (B3: the
activation pass, which quantizes x once into an int8 map, then the conv as an
int8 implicit GEMM on the same core) for CUDA tensors; CPU tensors run the
plain versions `*_ref`. The weights come in already
quantized (the port quantizes them once, when the scales are loaded), in the
layouts the kernels read:
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
from .gemm_tiles import A8W8_TILES, BK, CONV_TILES, a8w8_plan, conv_plan, max_clusters

_MAX_GRID_Y = 65535  # row tiles of 128 go on gridDim.y


def quantize_int8(x, sx: float):
    """round_half_even(x / sx) clipped to +-127, as int8; the multiply is by
    the fp32 reciprocal 1/sx, as the JAX kernels do."""
    return torch.round(x.float() * (1.0 / sx)).clamp_(-127, 127).to(torch.int8)


def quantize_weight_per_cout(w):
    """w: (O, ...) -> (int8 (O, ...), (O,) fp32 scales), per output channel:
    sw = max(|w|max, 1e-8) / 127. The port keeps torch's O-first layout; the
    JAX twin reduces over all but the last axis of its (..., O) kernels. The
    scale divides tensor by tensor (on the card PyTorch computes `t / 127.0`
    as t * (1 / 127)); the quantize multiplies by 1 / sw, as JAX's does."""
    wf = w.detach().float()
    wmax = wf.abs().amax(dim=tuple(range(1, w.ndim))).clamp(min=1e-8)
    sw = wmax / torch.full_like(wmax, 127.0)
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


def int8_a8w8_matmul_tiled_ref(x, wq, sw, sx: float, bias=None, plan=None):
    """The plain version, on the CPU, walked as the B2 kernel walks it at
    `plan` (by default `a8w8_plan` on an H100): per tile, int32 sums stage by
    stage over 64-deep K blocks of zero-padded operands (TMA's zero fill past
    M, N and K), the fp32 epilogue, and the store clipped to (M, N).
    Bit-exact with `int8_a8w8_matmul_ref`."""
    k, n = x.shape[-1], wq.shape[0]
    xq = quantize_int8(x.reshape(-1, k), sx)
    plan = plan or a8w8_plan(xq.shape[0], n, k)
    kp = plan.k_blocks * BK
    xq = F.pad(xq.int(), (0, kp - k, 0, plan.outer_tiles * 128 - xq.shape[0]))
    wp = F.pad(wq.int(), (0, kp - k, 0, plan.inner_tiles * plan.tile - n))
    scale = F.pad(sw.float(), (0, wp.shape[0] - n)) * sx
    bias_p = None if bias is None else F.pad(bias.float(), (0, wp.shape[0] - n))
    out = torch.empty((plan.m, n), dtype=torch.float32)
    for block in plan.walk():
        for outer, inner in block:
            if not plan.in_range(outer, inner):
                continue
            rows = slice(outer * 128, outer * 128 + 128)
            cols = slice(inner * plan.tile, (inner + 1) * plan.tile)
            acc = torch.zeros((128, plan.tile), dtype=torch.int32)
            for kb in range(plan.k_blocks):
                ks = slice(kb * BK, (kb + 1) * BK)
                acc += xq[rows, ks] @ wp[cols, ks].t()
            v = acc.float() * scale[cols]
            if bias_p is not None:
                v = v + bias_p[cols]
            r, c = plan.region(outer, inner)
            out[r, c] = v[:r.stop - r.start, :c.stop - c.start]
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


@functools.lru_cache(maxsize=None)
def _gemm_lib():
    from ..kernels import load_library

    lib = load_library("int8_gemm")
    lib.int8_gemm_bf16.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.int8_gemm_bf16.restype = ctypes.c_int
    lib.int8_gemm_smem.argtypes = [ctypes.c_int]
    lib.int8_gemm_smem.restype = ctypes.c_int
    return lib


def gemm_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of a B2 block at an N tile of `tile`."""
    return _gemm_lib().int8_gemm_smem(tile)


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
    """The shapes B3 and B5 take: TMA's 16-byte strides of the int8 map and
    8-column output chunks (the persistent walk has no grid limit)."""
    return c % 16 == 0 and o % 8 == 0


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _int8_gemm_cuda(x, wq, sw, sx, bias, tiles=A8W8_TILES):
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
    plan = a8w8_plan(m, n, k, max_clusters("int8_gemm", "int8_gemm_max_clusters", A8W8_TILES,
                                           x.device.index), tiles)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _gemm_lib().int8_gemm_bf16(x2.data_ptr(), wq.data_ptr(), sw.data_ptr(),
                                         0 if bias is None else bias.data_ptr(), out.data_ptr(),
                                         m, n, k, float(sx), 1.0 / sx, plan.tile, plan.grid,
                                         stream)
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


def conv3x3_tiled(xq, wq, sw, sx: float, bias=None, temb=None, residual=None, plan=None):
    """The conv of an int8 map xq (B, H, W, C), on the CPU, walked as the B3 /
    B5 kernel walks it at `plan` (by default `conv_plan` on an H100): per
    tile of `plan.pixels` pixels, int32 sums stage by stage over the 9 taps x
    64-channel chunks of zero-filled operands (TMA's zero fill outside the image and
    past C and O), the fp32 epilogue acc * (sw * sx) [+ bias] [+ temb[b]]
    [+ residual], and the store clipped to the map and O. fp32 (B, H, W, O)."""
    b, h, w, c = xq.shape
    o = wq.shape[0]
    plan = plan or conv_plan(b, h, w, c, o)
    kc = plan.chunks * BK
    # one pixel of zeros around the image, the edge tiles' overhang, channels to the chunks
    xp = torch.zeros((b, plan.tiles_h * plan.th + 2, plan.tiles_w * plan.tw + 2, kc),
                     dtype=torch.int32)
    xp[:, 1:h + 1, 1:w + 1, :c] = xq.int()
    wp = torch.zeros((plan.inner_tiles * plan.tile, 9, kc), dtype=torch.int32)
    wp[:o, :, :c] = wq.reshape(o, 9, c).int()
    out = torch.empty((b, h, w, o), dtype=torch.float32)
    for block in plan.walk():
        for outer, inner in block:
            if not plan.in_range(outer, inner):
                continue
            bi, y0, x0 = plan.origin(outer)
            cols = slice(inner * plan.tile, (inner + 1) * plan.tile)
            acc = torch.zeros((plan.th * plan.tw, plan.tile), dtype=torch.int32)
            for kb in range(plan.k_blocks):
                tap, chunk = divmod(kb, plan.chunks)
                dy, dx = divmod(tap, 3)  # the padded map's offset of tap (dy - 1, dx - 1)
                ks = slice(chunk * BK, (chunk + 1) * BK)
                a = xp[bi, y0 + dy:y0 + dy + plan.th, x0 + dx:x0 + dx + plan.tw, ks]
                acc += a.reshape(-1, BK) @ wp[cols, tap, ks].t()
            _, rows, xs, cs = plan.region(outer, inner)
            ny, nx, nc = rows.stop - rows.start, xs.stop - xs.start, cs.stop - cs.start
            v = acc.view(plan.th, plan.tw, plan.tile)[:ny, :nx, :nc].float() \
                * (sw[cs].float() * sx)
            if bias is not None:
                v = v + bias[cs].float()
            if temb is not None:
                v = v + temb[bi, cs].float()
            if residual is not None:
                v = v + residual[bi, rows, xs, cs].float()
            out[bi, rows, xs, cs] = v
    return out


def int8_conv3x3_tiled_ref(x, wq, sw, sx: float, bias=None, plan=None):
    """`int8_conv3x3_same_ref` walked as the kernel walks it (`conv3x3_tiled`
    on the activation pass's int8 map). Bit-exact with the plain version."""
    return conv3x3_tiled(quantize_int8(x, sx), wq, sw, sx, bias, plan=plan).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _conv_lib():
    from ..kernels import load_library

    lib = load_library("int8_conv3x3")
    lib.conv3x3_act_quant.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.conv3x3_gemm.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.conv3x3_smem.argtypes = [ctypes.c_int] * 2
    for fn in (lib.conv3x3_act_quant, lib.conv3x3_gemm, lib.conv3x3_smem):
        fn.restype = ctypes.c_int
    return lib


def conv_smem_bytes(tile: int, pixels: int) -> int:
    """Dynamic shared memory of a B3 / B5 conv block at a tile of `tile`
    columns by `pixels` pixels."""
    return _conv_lib().conv3x3_smem(tile, pixels)


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
        raise ValueError(f"{fn} kernel takes C % 16 == 0 and O % 8 == 0, got x "
                         f"{tuple(x.shape)} O={o}")
    return b, h, w, c, o


def conv3x3_act_quant(x, sx: float, stats=None, gamma=None, beta=None, groups: int = 1):
    """The activation pass on the card: x (B, H, W, C) bf16 -> its int8 map,
    q(x), or with the GroupNorm statistics stats = (mean, inv), each (B,
    groups) fp32, q(SiLU(x * scale + shift)) with gn_affine's scale and shift
    (gamma / beta fp32 or both bf16). Launches the pass once; not counted."""
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    b, h, w, c = x.shape
    mean, inv = stats if stats is not None else (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _conv_lib().conv3x3_act_quant(
            x.data_ptr(), *(0 if t is None else t.data_ptr() for t in (mean, inv, gamma, beta)),
            int(gamma is not None and gamma.dtype == torch.bfloat16), groups, xq.data_ptr(),
            b, h, w, c, 1.0 / sx, stream)
    _raise_on(err, "conv3x3_act_quant")
    return xq


@functools.lru_cache(maxsize=None)
def _conv_plan_on(index: int, b: int, h: int, w: int, c: int, o: int, tiles, pairings):
    """`conv_plan` on CUDA device `index`, once a shape (the UNet repeats them)."""
    return conv_plan(b, h, w, c, o, max_clusters("int8_conv3x3", "conv3x3_max_clusters",
                                                 CONV_TILES, index), tiles, pairings)


def conv3x3_gemm(xq, wq, sw, sx: float, bias=None, temb=None, residual=None,
                 tiles=CONV_TILES, pairings=(True, False)):
    """The conv of the int8 map xq on the card (the B3 / B5 kernel at the plan
    `conv_plan` picks among `tiles` and `pairings`) -> bf16 (B, H, W, O). Not
    counted."""
    b, h, w, c = xq.shape
    o = wq.shape[0]
    out = torch.empty((b, h, w, o), dtype=torch.bfloat16, device=xq.device)
    plan = _conv_plan_on(xq.device.index, b, h, w, c, o, tuple(tiles), tuple(pairings))
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _conv_lib().conv3x3_gemm(
            xq.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (bias, temb, residual)),
            out.data_ptr(), b, h, w, c, o, float(sx), plan.tile, plan.pixels, plan.tw,
            int(plan.pair_inner), plan.grid, stream)
    _raise_on(err, "conv3x3_gemm")
    return out


def _int8_conv3x3_cuda(x, wq, sw, sx, bias, **plan):
    bias = None if bias is None else bias.float()
    check_conv3x3_operands("int8_conv3x3_same", x, wq, sw, bias)
    out = conv3x3_gemm(conv3x3_act_quant(x, sx), wq, sw, sx, bias, **plan)
    int8_conv3x3_same.launches += 1
    return out


def int8_conv3x3_same(x, wq, sw, sx: float, bias: Optional[torch.Tensor] = None):
    """3x3 stride-1 SAME conv of NHWC x (B, H, W, C) with int8 wq (O, 3, 3, C)
    and static activation scale sx -> (B, H, W, O) (port of
    `int8_conv3x3_same`, plus the conv bias in the epilogue). CUDA tensors
    launch the B3 kernels (the activation pass, then the conv; counted once
    a call); CPU tensors run `int8_conv3x3_same_ref`."""
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
