"""Static-scale a8w8 PTQ: the scale scope and the quantized layers. Port of
the static half of paddlemix_tpu/ops/quant.py (static_a8w8_scope,
static_quant_dot_general, static_quant_conv_general_dilated).

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

from typing import List, Optional, Sequence

import torch
from torch import nn

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
    return (QuantLinear if quant else nn.Linear)(*args, **kwargs)


def conv2d(quant: bool, *args, **kwargs) -> nn.Conv2d:
    return (QuantConv2d if quant else nn.Conv2d)(*args, **kwargs)


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
