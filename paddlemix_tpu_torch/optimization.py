"""Learning-rate schedules and the optimizer (port of
paddlemix_tpu/optimization.py, which builds them from optax).

The schedules are the optax ones the JAX package calls, with their float32
arithmetic and their checks (`cosine_decay_schedule` refuses a decay of no
steps, so a cosine run needs more total steps than warmup steps). The
optimizer is the optax chain `create_optimizer` builds: clip by global norm,
then AdamW (Adam moments, decayed weights where the mask allows, times minus
the scheduled learning rate), and, with gradient accumulation, optax's
`MultiSteps` around it. It updates the fp32 parameters in place, where optax
returns new ones. Layer decay (`layer_decay` < 1) multiplies each
parameter's whole step, weight decay included, by its layer's scale, as the
JAX chain's `scale_by_layer_decay` after `adamw` does.
"""

from __future__ import annotations

import math
import re
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
    biases, embeddings or logit scales), on torch names."""
    return param.ndim > 1 and not any(
        tok in name for tok in ("norm", "bias", "embed", "logit_scale"))


def flax_weight_decay_mask(key_map) -> Callable[[str, torch.Tensor], bool]:
    """The JAX mask itself, on each parameter's flax name under `key_map`
    (core.convert): where torch and flax names part (EVA's `pos_embed` and
    `patch_embed.proj`, CLIP's `embeddings.patch_embedding`, which JAX
    decays), it decides as JAX does."""
    from .core.convert import torch_key_to_flax

    def mask(name: str, param: torch.Tensor) -> bool:
        flax = torch_key_to_flax(name, key_map)
        return param.ndim > 1 and not any(
            tok in flax for tok in ("norm", "bias", "embedding", "logit_scale"))
    return mask


def layer_id_for_param(path: str, num_max_layer: int) -> int:
    """A parameter's layer from its name (copy of the JAX package's, which
    takes flax paths and torch names alike): embeddings 0, block or layer i
    i + 1, everything else (norms after the blocks, heads, projections, the
    logit scale) num_max_layer - 1."""
    layer_0 = ("patch_embed", "pos_embed", "cls_token", "mask_token", "conv1",
               "positional_embedding", "token_embedding", "embed_tokens",
               "class_embedding", "position_embedding")
    if any(tok in path for tok in layer_0):
        return 0
    m = re.search(r"(?:blocks|layers)[._](\d+)", path)
    if m is not None:
        return int(m.group(1)) + 1
    return num_max_layer - 1


def layer_decay_scales(params: Dict[str, torch.Tensor], layer_decay: float,
                       num_layers: int) -> Dict[str, float]:
    """Each parameter's step scale, layer_decay ** (n - 1 - layer id) with
    n = num_layers + 2 (the embeddings, the blocks, the head)."""
    n = num_layers + 2
    values = [layer_decay ** (n - 1 - i) for i in range(n)]
    return {name: values[layer_id_for_param(name, n)] for name in params}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale_by_learning_rate(schedule), inside optax.MultiSteps when
    `every_k` > 1: gradients are averaged as they come, (g + n acc) / (n + 1),
    and the inner chain runs on the average every k-th call, whose schedule
    therefore counts real updates. State and updates are fp32. With
    `layer_scales` (name -> scale), each parameter's step is multiplied by
    its scale last (the JAX chain's `scale_by_layer_decay`)."""

    def __init__(self, schedule: Schedule, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 decay_mask: Optional[Callable[[str, torch.Tensor], bool]] = None,
                 max_grad_norm: Optional[float] = 1.0, every_k: int = 1,
                 layer_scales: Optional[Dict[str, float]] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.decay_mask = weight_decay, decay_mask
        self.max_grad_norm, self.every_k = max_grad_norm, every_k
        self.layer_scales = layer_scales

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

    # the state's counters: Adam's count (the schedule's position: the
    # updates made) and, under accumulation, MultiSteps' mini_step and
    # gradient_step
    _COUNTS = ("count", "mini_step", "gradient_step")

    def state_dict(self, state: dict) -> Dict[str, torch.Tensor]:
        """`state` flattened to tensors (views, no copy): "mu.<name>",
        "nu.<name>", under accumulation "acc.<name>" (the running mean of
        the window's gradients), and the counters as 0-d int64 tensors."""
        flat = {k: torch.tensor(state[k], dtype=torch.int64) for k in self._COUNTS if k in state}
        for kind in ("mu", "nu", "acc"):
            flat.update({f"{kind}.{n}": t for n, t in state.get(kind, {}).items()})
        return flat

    @torch.no_grad()
    def load_state_dict(self, state: dict, flat: Dict[str, torch.Tensor]) -> dict:
        """Copy `flat` (as `state_dict` gives it) into `state` in place: the
        moments and accumulators into their tensors (on their device), the
        counters as ints, so that a checkpoint taken inside an accumulation
        window resumes that window. Every key must match, with its shape."""
        want = self.state_dict(state)
        if set(want) != set(flat):
            raise KeyError(f"optimizer state: missing {sorted(set(want) - set(flat))[:5]}, "
                           f"unexpected {sorted(set(flat) - set(want))[:5]}")
        for k, t in want.items():
            if tuple(t.shape) != tuple(flat[k].shape):
                raise ValueError(f"optimizer state {k}: {tuple(flat[k].shape)} vs "
                                 f"{tuple(t.shape)}")
            if k in self._COUNTS:
                state[k] = int(flat[k])
            else:
                t.copy_(flat[k])
        return state

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
            u = step * u
            if self.layer_scales is not None:
                u = u * self.layer_scales[name]
            p.copy_((p.float() + u).to(p.dtype))
        state["count"] = count


def create_optimizer(learning_rate=1e-4, schedule: str = "cosine", total_steps: int = 10000,
                     warmup_steps: int = 0, weight_decay: float = 0.0, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8,
                     max_grad_norm: Optional[float] = 1.0, min_lr: float = 0.0,
                     layer_decay: Optional[float] = None,
                     params: Optional[Dict[str, torch.Tensor]] = None,
                     num_layers: Optional[int] = None, every_k: int = 1,
                     flax_key_map=None) -> Optimizer:
    """AdamW + grad clip + schedule, the JAX `create_optimizer`; `every_k` > 1
    wraps it as optax.MultiSteps does (the JAX Trainer's gradient
    accumulation). A callable `learning_rate` is the schedule itself.
    `layer_decay` < 1 scales each of `params`' steps by its layer
    (`layer_decay_scales` over `num_layers` blocks). With `flax_key_map` the
    weight-decay mask is JAX's on the flax names (`flax_weight_decay_mask`)."""
    scales = None
    if layer_decay is not None and layer_decay < 1.0:
        if params is None or num_layers is None:
            raise ValueError("layer_decay needs params and num_layers to build the "
                             "per-parameter scales")
        scales = layer_decay_scales(params, layer_decay, num_layers)
    if callable(learning_rate):
        lr = learning_rate
    elif schedule == "cosine":
        lr = cosine_decay_with_warmup(learning_rate, total_steps, warmup_steps, min_lr)
    elif schedule == "linear":
        lr = linear_decay_with_warmup(learning_rate, total_steps, warmup_steps)
    else:
        lr = constant_with_warmup(learning_rate, warmup_steps)
    mask = no_weight_decay_mask if flax_key_map is None else flax_weight_decay_mask(flax_key_map)
    return Optimizer(lr, b1=beta1, b2=beta2, eps=eps, weight_decay=weight_decay,
                     decay_mask=mask if weight_decay else None,
                     max_grad_norm=max_grad_norm, every_k=every_k, layer_scales=scales)
