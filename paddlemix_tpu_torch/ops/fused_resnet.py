"""Fused GroupNorm -> SiLU -> int8 quantize -> 3x3 conv with a bias / time
embedding / residual epilogue: the resnet half of the static-a8w8 path. Port
of paddlemix_tpu/ops/fused_resnet.py.

Per resnet conv on the card:
  1. the GroupNorm moments, (B, groups) mean and rsqrt(var + eps), from the
     GroupNorm kernel's own statistics passes (ops.norms.group_norm_stats);
  2. the activation pass of `csrc/int8_conv3x3.cu`: every element of x once,
     q(SiLU(x * scale[b, c] + shift[b, c])) into an int8 NHWC map, each
     thread forming its channels' scale and shift from the moments, gamma
     and beta with `gn_affine`'s roundings;
  3. the B5 conv of that map: an int8 implicit GEMM on the wgmma core whose
     TMA boxes zero-fill the taps outside the image (the conv pads the
     activated map with zeros, and SiLU(shift) is not zero), and whose
     epilogue adds bias[o], temb[b, o] and residual[b, h, w, o] in fp32.
So x is read twice (statistics, activation pass) and the normalized map is
never written; the conv reads the int8 map, half of x's bytes.

CUDA tensors launch the kernels; CPU tensors run `fused_gn_silu_conv3x3_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .autograd import refuse_grad
from .conv_int8 import (
    check_conv3x3_operands,
    conv3x3_act_quant,
    conv3x3_gemm,
    conv3x3_tiled,
    int8_conv3x3_ref,
    quantize_int8,
)
from .norms import group_norm_stats


def gn_affine(x, gamma, beta, groups: int, eps: float):
    """(B, ..., C) -> (B, 2, C) fp32 [scale, shift] with GroupNorm(x) =
    x * scale + shift per (batch, channel) (port of `gn_affine`)."""
    return _affine(group_norm_stats(x, groups, eps), gamma, beta)


def _affine(stats, gamma, beta):
    """`gn_affine` from the moments stats = (mean, inv), each (B, groups)."""
    mean, inv = stats
    cpg = gamma.shape[0] // mean.shape[-1]
    scale = inv.repeat_interleave(cpg, dim=-1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(cpg, dim=-1) * scale
    return torch.stack([scale, shift], dim=1)


def gn_silu_quantize_ref(x, stats, gamma, beta, sx: float):
    """Plain version of the activation pass: q(SiLU(x * scale + shift)), int8
    (B, H, W, C), with `gn_affine`'s scale and shift from stats = (mean,
    inv)."""
    aff = _affine(stats, gamma, beta)
    y = x.float() * aff[:, 0, None, None, :] + aff[:, 1, None, None, :]
    return quantize_int8(y * torch.sigmoid(y), sx)


def fused_gn_silu_conv3x3_ref(x, gamma, beta, groups: int, eps: float, wq, sw, sx: float,
                              bias, temb=None, residual=None):
    """Plain version (port of `fused_gn_silu_conv3x3_ref`): the same
    quantization math composed from plain ops. x (B, H, W, C) NHWC, wq
    (O, 3, 3, C) int8, temb (B, O), residual (B, H, W, O) -> x.dtype."""
    xq = gn_silu_quantize_ref(x, group_norm_stats(x, groups, eps), gamma, beta, sx)
    out = int8_conv3x3_ref(xq, wq, sw, sx, bias)
    if temb is not None:
        out = out + temb.float()[:, None, None, :]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def fused_gn_silu_conv3x3_tiled_ref(x, gamma, beta, groups: int, eps: float, wq, sw, sx: float,
                                    bias, temb=None, residual=None, plan=None):
    """The plain version walked as the kernels run it: the statistics, the
    activation pass's int8 map, then the conv tile by tile (`conv3x3_tiled`
    at `plan`). Bit-exact with `fused_gn_silu_conv3x3_ref`."""
    xq = gn_silu_quantize_ref(x, group_norm_stats(x, groups, eps), gamma, beta, sx)
    return conv3x3_tiled(xq, wq, sw, sx, bias, temb, residual, plan).to(x.dtype)


def _affine_operands(gamma, beta, c, device):
    """gamma / beta as the activation pass reads them: (C,) contiguous, both
    fp32 or both bf16."""
    if gamma.dtype != beta.dtype or gamma.dtype not in (torch.float32, torch.bfloat16):
        gamma, beta = gamma.float(), beta.float()
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != device or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"fused_gn_silu_conv3x3: {name} must be a contiguous ({c},) "
                             f"tensor on {device}, got {tuple(t.shape)} on {t.device}")
    return gamma, beta


def _fused_cuda(x, gamma, beta, groups, eps, wq, sw, sx, bias, temb, residual, **plan):
    bias = bias.float()
    b, h, w, c, o = check_conv3x3_operands("fused_gn_silu_conv3x3", x, wq, sw, bias)
    for name, t, shape in (("temb", temb, (b, o)), ("residual", residual, (b, h, w, o))):
        if t is not None and (t.device != x.device or t.dtype != torch.bfloat16
                              or tuple(t.shape) != shape or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"fused_gn_silu_conv3x3: {name} must be a contiguous, 16-byte "
                             f"aligned bf16 {shape} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    gamma, beta = _affine_operands(gamma, beta, c, x.device)
    xq = conv3x3_act_quant(x, sx, group_norm_stats(x, groups, eps), gamma, beta, groups)
    out = conv3x3_gemm(xq, wq, sw, sx, bias, temb, residual, **plan)
    fused_gn_silu_conv3x3.launches += 1
    return out


def fused_gn_silu_conv3x3(x, gamma, beta, groups: int, eps: float, wq, sw, sx: float, bias,
                          temb: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None):
    """GroupNorm(groups, eps; gamma, beta) -> SiLU -> int8 conv3x3 SAME with
    static activation scale sx -> + bias [+ temb] [+ residual] (port of
    `fused_gn_silu_conv3x3`). x (B, H, W, C) NHWC; wq (O, 3, 3, C) int8 and
    sw (O,) from `quantize_weight_per_cout`; temb (B, O); residual
    (B, H, W, O). CUDA tensors launch the B5 kernels (bf16 activations: the
    statistics, the activation pass, the conv; counted once a call); CPU
    tensors run the plain version."""
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
