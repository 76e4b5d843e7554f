"""Trainer: the training loop on one card (port of
paddlemix_tpu/trainer/trainer.py).

The model contributes a loss_fn(params, batch, rng); `rng` is a
torch.Generator on the params' device, seeded from `args.seed` at each
`train` call and drawn from by the steps in turn (JAX seeds PRNGKey(seed)
and splits it each step: every step's draws are fresh, the run's repeat).
The Trainer owns the optimizer, gradient accumulation (optax.MultiSteps
semantics: `step` counts micro-batches, the schedule counts real updates,
and `max_steps` and the schedule's total are micro-batches, as in JAX), the
device put-ahead of batches (`prefetch_depth`) and logging (loss,
grad_norm, ips, reader_cost).
Not ported yet, and refused: checkpoint save and resume (orbax in JAX),
evaluation, the device mesh (any parallel degree above 1) and
`MeshAwareLoss`, TensorBoard and profiler callbacks (ROADMAP). The
`benchmark` flag's callback (ips and peak memory lines) is not ported and
the flag is ignored.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..optimization import create_optimizer
from .arguments import TrainingArguments
from .train_state import TrainState, create_train_state, make_train_step

logger = logging.getLogger(__name__)


class MeshAwareLoss:
    """The JAX `mesh -> loss_fn` factory for pipeline and expert parallel
    losses: the port has no mesh, so building one refuses."""

    def __init__(self, factory: Callable):
        raise NotImplementedError("MeshAwareLoss: the device mesh is not ported yet")


class Trainer:
    def __init__(self, model=None, args: Optional[TrainingArguments] = None,
                 loss_fn: Optional[Callable] = None,
                 train_dataloader: Optional[Iterable] = None,
                 eval_dataloader: Optional[Iterable] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 callbacks: Optional[list] = None):
        self.model = model
        self.args = args or TrainingArguments()
        self.loss_fn = loss_fn
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader
        if params is None and model is not None:
            params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.params = params
        self.callbacks = callbacks or []
        self.state: Optional[TrainState] = None
        # every step's step, loss and grad_norm (device scalars, read after
        # training) and host time when the step function returned
        self.history: list = []

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    # ------------------------------------------------------------ setup
    def _total_steps(self, steps_per_epoch: Optional[int]) -> int:
        if self.args.max_steps > 0:
            return self.args.max_steps
        if steps_per_epoch:
            return steps_per_epoch * self.args.num_train_epochs
        return 10000

    def _refuse_unported(self):
        a = self.args
        degrees = {name: getattr(a, name) for name in (
            "fsdp_parallel_degree", "tensor_parallel_degree", "sequence_parallel_degree",
            "pipeline_parallel_degree", "expert_parallel_degree")}
        if a.data_parallel_degree not in (-1, 1) or any(d != 1 for d in degrees.values()):
            raise NotImplementedError(f"Trainer: the device mesh is not ported yet "
                                      f"(data_parallel_degree {a.data_parallel_degree}, "
                                      f"{degrees})")
        if a.resume_from_checkpoint:
            raise NotImplementedError("Trainer: checkpoint resume is not ported yet")
        if a.report_to != "none" or a.profiler_options:
            raise NotImplementedError("Trainer: TensorBoard and profiler callbacks are not "
                                      "ported yet")

    def setup(self, steps_per_epoch: Optional[int] = None):
        a = self.args
        self._refuse_unported()
        ld_kwargs = {}
        if a.layer_decay and a.layer_decay < 1.0:
            # layer-decayed steps; the block count from the model's config,
            # as in JAX
            cfg = getattr(self.model, "config", None)
            n_layers = (getattr(cfg, "num_hidden_layers", None)
                        or getattr(cfg, "num_layers", None) or 12)
            ld_kwargs = dict(layer_decay=a.layer_decay, params=self.params,
                             num_layers=n_layers)
        tx = create_optimizer(
            a.learning_rate, schedule=a.lr_scheduler_type,
            total_steps=self._total_steps(steps_per_epoch), warmup_steps=a.warmup_steps,
            weight_decay=a.weight_decay, beta1=a.adam_beta1, beta2=a.adam_beta2,
            eps=a.adam_epsilon, max_grad_norm=a.max_grad_norm,
            every_k=a.gradient_accumulation_steps,
            flax_key_map=getattr(self.model, "flax_key_map", None), **ld_kwargs)
        self.tx = tx
        self.state = create_train_state(self.params, tx)
        self.step_fn = make_train_step(self.loss_fn, tx)
        return self

    # ------------------------------------------------------------ unported
    def save_checkpoint(self, step: int):
        raise NotImplementedError("Trainer.save_checkpoint: checkpoints are not ported yet "
                                  "(set save_steps 0)")

    def load_checkpoint(self, path_or_latest: str):
        raise NotImplementedError("Trainer.load_checkpoint: checkpoints are not ported yet")

    def evaluate(self, eval_dataloader=None, prefix: str = "eval"):
        raise NotImplementedError("Trainer.evaluate: evaluation is not ported yet")

    # ------------------------------------------------------------ loop
    def _prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the params' device: on a card, copied from
        pinned host memory without blocking the host."""
        dev = self.device
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
        return out

    def train(self, max_steps: Optional[int] = None):
        """Run micro-batch steps until `max_steps` (else the args' max_steps,
        else the epochs); returns {"final_step": ..., and the last step's
        metrics as floats}."""
        a = self.args
        assert self.train_dataloader is not None and self.loss_fn is not None
        if self.state is None:
            try:
                steps_per_epoch = len(self.train_dataloader)
            except TypeError:
                steps_per_epoch = None
            self.setup(steps_per_epoch)
        total = max_steps or self._total_steps(None)
        explicit_steps = max_steps is not None or a.max_steps > 0
        n_epochs = 10 ** 9 if explicit_steps else max(a.num_train_epochs, 1)
        step = self.state.step
        rng = torch.Generator(device=self.device).manual_seed(a.seed)
        metrics: Dict[str, torch.Tensor] = {}
        ips_window, reader_window, t_last = [], [], time.time()
        for _ in range(n_epochs):
            # device put-ahead: the next batches are copied to the card while
            # this one trains
            batches = _prefetch_to_device(iter(self.train_dataloader), self._prepare_batch,
                                          depth=a.prefetch_depth)
            for t_reader, batch in batches:
                if step >= total:
                    break
                reader_window.append(t_reader)
                samples = int(next(iter(batch.values())).shape[0])
                self.state, metrics = self.step_fn(self.state, batch, rng)
                step += 1
                self.history.append({"step": step, "loss": metrics["loss"],
                                     "grad_norm": metrics["grad_norm"],
                                     "time": time.perf_counter(), "reader": t_reader})
                now = time.time()
                ips_window.append(samples / max(now - t_last, 1e-9))
                t_last = now
                if step % a.logging_steps == 0:
                    ips = float(np.mean(ips_window[-a.logging_steps:]))
                    # the time the loop sat blocked on the loader, after the
                    # put-ahead, and its share of the step (the JAX telemetry)
                    reader_cost = float(np.mean(reader_window[-a.logging_steps:]))
                    reader_pct = reader_cost * ips / max(samples, 1) * 100
                    logger.info("step %d/%d loss: %.4f grad_norm: %.4f ips: %.3f samples/sec "
                                "reader_cost: %.5f sec (%.1f%%)", step, total,
                                float(metrics["loss"]), float(metrics["grad_norm"]), ips,
                                reader_cost, reader_pct)
                    for cb in self.callbacks:
                        cb(step=step, metrics={**metrics, "ips": ips, "reader_cost": reader_cost})
                if a.save_steps and step % a.save_steps == 0:
                    self.save_checkpoint(step)
            if step >= total:
                break
        if a.do_eval and self.eval_dataloader is not None:
            self.evaluate()
        return {"final_step": step, **{k: float(v) for k, v in metrics.items()}}


def _prefetch_to_device(it, prepare, depth: int = 2):
    """Keep `depth` prepared (on the device) batches in hand (port of the JAX
    `_prefetch_to_device`; depth 0 or 1: none ahead). Yields (seconds the
    loop sat blocked pulling from the host iterator, batch)."""
    buf = collections.deque()
    stall = 0.0
    while True:
        while len(buf) < max(depth, 1):
            t0 = time.perf_counter()
            nxt = next(it, _SENTINEL)
            stall += time.perf_counter() - t0
            if nxt is _SENTINEL:
                break
            buf.append(prepare(nxt))
        if not buf:
            return
        yield stall, buf.popleft()
        stall = 0.0


_SENTINEL = object()
