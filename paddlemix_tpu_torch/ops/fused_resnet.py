"""Fused GroupNorm -> SiLU -> int8 quantize -> 3x3 conv with a bias / time
embedding / residual epilogue: the resnet half of the static-a8w8 path. Port
of paddlemix_tpu/ops/fused_resnet.py.

Per resnet conv:
  1. `gn_affine`: per-(batch, channel) fp32 scale and shift from the
     GroupNorm moments, (B, 2, C). On the card the moments come from the
     GroupNorm kernel's own statistics passes (ops.norms.group_norm_stats), so
     x is read once here and once by the conv; the normalized map is never
     written.
  2. the B5 kernel of `csrc/int8_conv3x3.cu`: an implicit GEMM whose A-tile
     prologue applies the affine, SiLU and the static-scale int8 quantize to
     every gathered element, with int8 zero for taps outside the image (the
     conv pads the activated map with zeros, and SiLU(shift) is not zero), and
     whose epilogue adds bias[o], temb[b, o] and residual[b, h, w, o] in fp32.

CUDA tensors launch the kernel; CPU tensors run `fused_gn_silu_conv3x3_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .autograd import refuse_grad
from .conv_int8 import _conv_lib, _raise_on, check_conv3x3_operands, int8_conv3x3_ref, \
    quantize_int8
from .norms import group_norm_stats


def gn_affine(x, gamma, beta, groups: int, eps: float):
    """(B, ..., C) -> (B, 2, C) fp32 [scale, shift] with GroupNorm(x) =
    x * scale + shift per (batch, channel) (port of `gn_affine`)."""
    cpg = x.shape[-1] // groups
    mean, inv = group_norm_stats(x, groups, eps)
    scale = inv.repeat_interleave(cpg, dim=-1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(cpg, dim=-1) * scale
    return torch.stack([scale, shift], dim=1)


def fused_gn_silu_conv3x3_ref(x, gamma, beta, groups: int, eps: float, wq, sw, sx: float,
                              bias, temb=None, residual=None):
    """Plain version (port of `fused_gn_silu_conv3x3_ref`): the same
    quantization math composed from plain ops. x (B, H, W, C) NHWC, wq
    (O, 3, 3, C) int8, temb (B, O), residual (B, H, W, O) -> x.dtype."""
    aff = gn_affine(x, gamma, beta, groups, eps)
    y = x.float() * aff[:, 0, None, None, :] + aff[:, 1, None, None, :]
    y = y * torch.sigmoid(y)
    out = int8_conv3x3_ref(quantize_int8(y, sx), wq, sw, sx, bias)
    if temb is not None:
        out = out + temb.float()[:, None, None, :]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _fused_cuda(x, gamma, beta, groups, eps, wq, sw, sx, bias, temb, residual):
    bias = bias.float()
    b, h, w, c, o = check_conv3x3_operands("fused_gn_silu_conv3x3", x, wq, sw, bias)
    aff = gn_affine(x, gamma, beta, groups, eps)
    for name, t, shape in (("temb", temb, (b, o)), ("residual", residual, (b, h, w, o))):
        if t is not None and (t.device != x.device or t.dtype != torch.bfloat16
                              or tuple(t.shape) != shape or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"fused_gn_silu_conv3x3: {name} must be a contiguous, 16-byte "
                             f"aligned bf16 {shape} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((b, h, w, o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _conv_lib().fused_gn_silu_conv3x3_bf16(
            x.data_ptr(), aff.data_ptr(), wq.data_ptr(), sw.data_ptr(), bias.data_ptr(),
            0 if temb is None else temb.data_ptr(),
            0 if residual is None else residual.data_ptr(), out.data_ptr(),
            b, h, w, c, o, float(sx), 1.0 / sx, stream)
    _raise_on(err, "fused_gn_silu_conv3x3_bf16")
    fused_gn_silu_conv3x3.launches += 1
    return out


def fused_gn_silu_conv3x3(x, gamma, beta, groups: int, eps: float, wq, sw, sx: float, bias,
                          temb: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None):
    """GroupNorm(groups, eps; gamma, beta) -> SiLU -> int8 conv3x3 SAME with
    static activation scale sx -> + bias [+ temb] [+ residual] (port of
    `fused_gn_silu_conv3x3`). x (B, H, W, C) NHWC; wq (O, 3, 3, C) int8 and
    sw (O,) from `quantize_weight_per_cout`; temb (B, O); residual
    (B, H, W, O). CUDA tensors launch the B5 kernel (bf16 activations);
    CPU tensors run the plain version."""
    if x.shape[-1] % groups:
        raise ValueError(f"fused_gn_silu_conv3x3: channels {x.shape[-1]} not divisible by "
                         f"groups {groups}")
    if x.is_cuda:
        refuse_grad("fused_gn_silu_conv3x3", x, gamma, beta, sw, bias, temb, residual)
        return _fused_cuda(x, gamma, beta, groups, eps, wq, sw, sx, bias, temb, residual)
    if x.device.type != "cpu":
        raise ValueError(f"fused_gn_silu_conv3x3: unsupported device {x.device}")
    return fused_gn_silu_conv3x3_ref(x, gamma, beta, groups, eps, wq, sw, sx, bias, temb,
                                     residual)


fused_gn_silu_conv3x3.launches = 0  # kernel launches (CUDA tensors only)
