"""EMA of model parameters with decay warmup (port of
paddlemix_tpu/trainer/ema.py: the reference's ppdiffusers EMAModel). The
decay is computed in fp32 as JAX computes it; the average is a new dict of
tensors, as JAX returns a new tree."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

_F32 = np.float32


class EMAState(NamedTuple):
    params: Dict[str, torch.Tensor]
    count: int


def ema_init(params: Dict[str, torch.Tensor]) -> EMAState:
    return EMAState({n: p.detach().clone() for n, p in params.items()}, 0)


def _decay(count: int, decay: float = 0.9999, use_warmup: bool = True,
              inv_gamma: float = 1.0, power: float = 2 / 3) -> float:
    """The decay of update `count` (1-based): with warmup 1 - (1 + count /
    inv_gamma) ** -power clipped to [0, decay], in fp32."""
    if not use_warmup:
        return float(_F32(decay))
    cur = _F32(1) - (_F32(1) + _F32(count) / _F32(inv_gamma)) ** _F32(-power)
    return float(np.clip(cur, _F32(0), _F32(decay)))


@torch.no_grad()
def ema_update(state: EMAState, new_params: Dict[str, torch.Tensor], decay: float = 0.9999,
               use_warmup: bool = True, inv_gamma: float = 1.0,
               power: float = 2 / 3) -> EMAState:
    count = state.count + 1
    cur = _decay(count, decay, use_warmup, inv_gamma, power)
    keep = float(_F32(1) - _F32(cur))
    return EMAState({n: e * cur + new_params[n].to(e.dtype) * keep
                     for n, e in state.params.items()}, count)
