"""The train state and one training step (port of
paddlemix_tpu/trainer/train_state.py without its mesh: one card)."""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from ..optimization import Optimizer, global_norm


class TrainState(NamedTuple):
    """step counts the calls of the step function (micro-batches under
    accumulation), as the JAX state's step does."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any


def create_train_state(params: Dict[str, torch.Tensor], tx: Optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def make_train_step(loss_fn: Callable, tx: Optimizer) -> Callable:
    """(state, batch, rng) -> (state, metrics), the JAX `make_train_step`
    without jit: loss_fn(params, batch, rng) -> loss or (loss, aux dict);
    the gradients of the params (by `torch.autograd.grad`), then the
    optimizer's update in place. metrics: loss, grad_norm (of this call's
    gradients, as JAX reports it) and aux, as device scalars."""

    def step_fn(state: TrainState, batch, rng):
        out = loss_fn(state.params, batch, rng)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        tx.update(grads, state.opt_state, state.params)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads.values()), **aux}
        return TrainState(state.step + 1, state.params, state.opt_state), metrics

    return step_fn
