"""Learning-rate schedules and the optimizer (port of
paddlemix_tpu/optimization.py, which builds them from optax).

The schedules are the optax ones the JAX package calls, with their float32
arithmetic and their checks (`cosine_decay_schedule` refuses a decay of no
steps, so a cosine run needs more total steps than warmup steps). The
optimizer is the optax chain `create_optimizer` builds: clip by global norm,
then AdamW (Adam moments, decayed weights where the mask allows, times minus
the scheduled learning rate), and, with gradient accumulation, optax's
`MultiSteps` around it. It updates the fp32 parameters in place, where optax
returns new ones. Layer decay is not ported yet (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
_F32 = np.float32


def _linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial power 1, no transition_begin)."""
    if transition_steps <= 0:
        return lambda count: float(_F32(init_value))

    def schedule(count):
        frac = _F32(1) - _F32(min(max(count, 0), transition_steps)) / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))
    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cosine + _F32(alpha)))
    return schedule


def _join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i + 1 from boundary i on, counted from it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out
    return schedule


def cosine_decay_with_warmup(learning_rate: float, total_steps: int, warmup_steps: int = 0,
                             min_lr: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1), max(total, 2), min_lr)."""
    warmup, decay = max(warmup_steps, 1), max(total_steps, 2)
    alpha = 0.0 if learning_rate == 0.0 else min_lr / learning_rate
    return _join_schedules([_linear_schedule(0.0, learning_rate, warmup),
                            _cosine_decay_schedule(learning_rate, decay - warmup, alpha)],
                           [warmup])


def linear_decay_with_warmup(learning_rate: float, total_steps: int,
                             warmup_steps: int = 0) -> Schedule:
    warmup = max(warmup_steps, 1)
    return _join_schedules([_linear_schedule(0.0, learning_rate, warmup),
                            _linear_schedule(learning_rate, 0.0,
                                             max(total_steps - warmup_steps, 1))], [warmup])


def constant_with_warmup(learning_rate: float, warmup_steps: int = 0) -> Schedule:
    warmup = max(warmup_steps, 1)
    return _join_schedules([_linear_schedule(0.0, learning_rate, warmup),
                            lambda count: float(_F32(learning_rate))], [warmup])


SCHEDULES = {
    "cosine": cosine_decay_with_warmup,
    "linear": linear_decay_with_warmup,
    "constant": constant_with_warmup,
}


def no_weight_decay_mask(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies (the JAX mask: not 1-D params, norms,
    biases, embeddings or logit scales)."""
    return param.ndim > 1 and not any(
        tok in name for tok in ("norm", "bias", "embed", "logit_scale"))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale_by_learning_rate(schedule), inside optax.MultiSteps when
    `every_k` > 1: gradients are averaged as they come, (g + n acc) / (n + 1),
    and the inner chain runs on the average every k-th call, whose schedule
    therefore counts real updates. State and updates are fp32."""

    def __init__(self, schedule: Schedule, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 decay_mask: Optional[Callable[[str, torch.Tensor], bool]] = None,
                 max_grad_norm: Optional[float] = 1.0, every_k: int = 1):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.decay_mask = weight_decay, decay_mask
        self.max_grad_norm, self.every_k = max_grad_norm, every_k

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in params.items()}
        state = {"mu": zeros(), "nu": zeros(), "count": 0}
        if self.every_k > 1:
            state.update(acc=zeros(), mini_step=0, gradient_step=0)
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> bool:
        """Apply one call's gradients to `params` in place; returns whether
        the parameters changed (always without accumulation; every k-th call
        with it)."""
        if self.every_k > 1:
            n = state["mini_step"]
            for name, g in grads.items():
                acc = state["acc"][name]
                acc.copy_((g.float() + n * acc) / (n + 1))
            if n < self.every_k - 1:
                state["mini_step"] = n + 1
                return False
            self._inner(state["acc"], state, params)
            state["mini_step"] = 0
            state["gradient_step"] += 1
            for acc in state["acc"].values():
                acc.zero_()
            return True
        self._inner(grads, state, params)
        return True

    def _inner(self, grads, state, params):
        b1, b2 = _F32(self.b1), _F32(self.b2)
        grads = {n: g.float() for n, g in grads.items()}
        if self.max_grad_norm:
            g_norm = global_norm(grads.values())
            if not bool(g_norm < self.max_grad_norm):
                grads = {n: g / g_norm * self.max_grad_norm for n, g in grads.items()}
        count = state["count"] + 1  # Adam's count after this update; the schedule's before it
        correction1 = float(_F32(1) - b1 ** _F32(count))
        correction2 = float(_F32(1) - b2 ** _F32(count))
        step = -self.schedule(state["count"])
        for name, p in params.items():
            g, mu, nu = grads[name], state["mu"][name], state["nu"][name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / correction1) / (torch.sqrt(nu / correction2) + self.eps)
            if self.weight_decay and (self.decay_mask is None or self.decay_mask(name, p)):
                u = u + self.weight_decay * p.float()
            p.copy_((p.float() + step * u).to(p.dtype))
        state["count"] = count


def create_optimizer(learning_rate=1e-4, schedule: str = "cosine", total_steps: int = 10000,
                     warmup_steps: int = 0, weight_decay: float = 0.0, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8,
                     max_grad_norm: Optional[float] = 1.0, min_lr: float = 0.0,
                     layer_decay: Optional[float] = None, every_k: int = 1) -> Optimizer:
    """AdamW + grad clip + schedule, the JAX `create_optimizer`; `every_k` > 1
    wraps it as optax.MultiSteps does (the JAX Trainer's gradient
    accumulation). A callable `learning_rate` is the schedule itself."""
    if layer_decay is not None and layer_decay < 1.0:
        raise NotImplementedError("create_optimizer: layer_decay is not ported yet")
    if callable(learning_rate):
        lr = learning_rate
    elif schedule == "cosine":
        lr = cosine_decay_with_warmup(learning_rate, total_steps, warmup_steps, min_lr)
    elif schedule == "linear":
        lr = linear_decay_with_warmup(learning_rate, total_steps, warmup_steps)
    else:
        lr = constant_with_warmup(learning_rate, warmup_steps)
    return Optimizer(lr, b1=beta1, b2=beta2, eps=eps, weight_decay=weight_decay,
                     decay_mask=no_weight_decay_mask if weight_decay else None,
                     max_grad_norm=max_grad_norm, every_k=every_k)
