"""The train state, its flat form for checkpoints, and one training step
(port of paddlemix_tpu/trainer/train_state.py without its mesh: one card)."""

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


def train_state_dict(state: TrainState, tx: Optimizer) -> Dict[str, torch.Tensor]:
    """The whole state as one flat dict of tensors (views): "step" (0-d
    int64), "params.<name>" and "opt_state.<key>" (`Optimizer.state_dict`)."""
    flat = {"step": torch.tensor(state.step, dtype=torch.int64)}
    flat.update({f"params.{n}": p.detach() for n, p in state.params.items()})
    flat.update({f"opt_state.{k}": t for k, t in tx.state_dict(state.opt_state).items()})
    return flat


@torch.no_grad()
def load_train_state(state: TrainState, flat: Dict[str, torch.Tensor],
                     tx: Optimizer) -> TrainState:
    """`flat` (as `train_state_dict` gives it) into `state`: the params and
    the optimizer's tensors copied in place (a model whose parameters they
    are sees them), the counters set; returns the state at the restored
    step. Every key must match, with its shape."""
    params = {k[len("params."):]: t for k, t in flat.items() if k.startswith("params.")}
    if set(params) != set(state.params):
        raise KeyError(f"train state params: missing {sorted(set(state.params) - set(params))[:5]}"
                       f", unexpected {sorted(set(params) - set(state.params))[:5]}")
    for n, p in state.params.items():
        if tuple(p.shape) != tuple(params[n].shape):
            raise ValueError(f"train state params.{n}: {tuple(params[n].shape)} vs "
                             f"{tuple(p.shape)}")
        p.copy_(params[n])
    tx.load_state_dict(state.opt_state, {k[len("opt_state."):]: t for k, t in flat.items()
                                         if k.startswith("opt_state.")})
    return TrainState(int(flat["step"]), state.params, state.opt_state)


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
