"""Trainer: the training loop on one card (port of
paddlemix_tpu/trainer/trainer.py).

The model contributes a loss_fn(params, batch, rng); `rng` is a
torch.Generator on the params' device, seeded from `args.seed` at each
`train` call and drawn from by the steps in turn (JAX seeds PRNGKey(seed)
and splits it each step: every step's draws are fresh, the run's repeat).
The Trainer owns the optimizer, gradient accumulation (optax.MultiSteps
semantics: `step` counts micro-batches, the schedule counts real updates,
and `max_steps` and the schedule's total are micro-batches, as in JAX), the
device put-ahead of batches (`prefetch_depth`), logging (loss, grad_norm,
ips, reader_cost) and callbacks, checkpoints and evaluation.

Checkpoints take JAX's orbax layout, one directory a step,
`output_dir/checkpoints/<step>/`, holding the whole train state (step,
params, the optimizer's moments, accumulators and counters) in one
safetensors file written by `core.safetensors` (synchronously, where orbax
writes in the background: `finalize_checkpoints` has nothing to wait for).
`save_total_limit` keeps the newest; `load_checkpoint` takes "latest", a
step directory (its leaf is the step) or a step. A resumed run keeps JAX's
semantics: step, params and optimizer state come back, and the loop starts
the loader and the seeded generator afresh (the data position is not
replayed). Evaluation runs under `torch.inference_mode`. Not ported: the
device mesh (any parallel degree above 1) and `MeshAwareLoss` (ROADMAP).
"""

from __future__ import annotations

import collections
import logging
import os
import re
import shutil
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core import safetensors
from ..optimization import create_optimizer
from .arguments import TrainingArguments
from .train_state import (
    TrainState,
    create_train_state,
    load_train_state,
    make_train_step,
    train_state_dict,
)

CHECKPOINT_NAME = "state.safetensors"

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
                 eval_fn: Optional[Callable] = None,
                 compute_metrics: Optional[Callable] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 callbacks: Optional[list] = None):
        self.model = model
        self.args = args or TrainingArguments()
        self.loss_fn = loss_fn
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader
        # eval_fn(params, batch) -> dict of per-batch scalars or arrays
        # (default {"loss": loss_fn(...)}); compute_metrics(outputs) folds the
        # arrays, concatenated over the batches, into corpus metrics
        self.eval_fn = eval_fn
        self.compute_metrics = compute_metrics
        if params is None and model is not None:
            params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.params = params
        self.callbacks = callbacks or []
        self.state: Optional[TrainState] = None
        self.best_metric: Optional[float] = None
        self.best_step: Optional[int] = None
        self._preempted = False
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
        if a.profiler_options:
            from .callbacks import parse_profiler_options

            cb = parse_profiler_options(a.profiler_options)
            if cb is not None:
                self.callbacks.append(cb)
        if a.benchmark:
            from .callbacks import BenchmarkCallback

            self.callbacks.append(BenchmarkCallback())
        if a.report_to == "tensorboard":
            from .callbacks import TensorBoardCallback

            self.callbacks.append(TensorBoardCallback(os.path.join(a.output_dir, "tb")))
        if a.resume_from_checkpoint:
            self.load_checkpoint(a.resume_from_checkpoint)
        return self

    # ------------------------------------------------------------ checkpoints
    @property
    def checkpoint_dir(self) -> str:
        return os.path.abspath(os.path.join(self.args.output_dir, "checkpoints"))

    def checkpoint_steps(self) -> list:
        """The steps saved under `checkpoint_dir`, oldest first."""
        if not os.path.isdir(self.checkpoint_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.checkpoint_dir) if re.fullmatch(r"\d+", d)
                      and os.path.isfile(os.path.join(self.checkpoint_dir, d, CHECKPOINT_NAME)))

    def save_checkpoint(self, step: int) -> str:
        """Write the train state to `checkpoint_dir/<step>/` (a new directory
        renamed into place once written), then keep the newest
        `save_total_limit` steps. Returns the directory."""
        final = os.path.join(self.checkpoint_dir, str(step))
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        flat = train_state_dict(self.state, self.tx)
        try:
            nbytes = safetensors.save_file(flat, os.path.join(tmp, CHECKPOINT_NAME),
                                           metadata={"step": str(self.state.step)})
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        logger.info("saved checkpoint step %d (%d tensors, %.3f GB) to %s", step, len(flat),
                    nbytes / 1e9, final)
        limit = self.args.save_total_limit
        if limit:
            for old in self.checkpoint_steps()[:-limit]:
                shutil.rmtree(os.path.join(self.checkpoint_dir, str(old)))
        return final

    def load_checkpoint(self, path_or_latest: str):
        """Restore the train state from "latest" (the newest step under
        `checkpoint_dir`; none: a warning), a step directory (its leaf is the
        step, as JAX reads it) or a step number; the params and the
        optimizer's tensors are copied in place."""
        if self.state is None:
            self.setup()
        if path_or_latest == "latest":
            steps = self.checkpoint_steps()
            if not steps:
                logger.warning("no checkpoint to resume from")
                return
            path = os.path.join(self.checkpoint_dir, str(steps[-1]))
        elif os.path.isdir(str(path_or_latest)):
            path = str(path_or_latest)
            int(os.path.basename(os.path.normpath(path)))  # the leaf must be a step
        else:
            path = os.path.join(self.checkpoint_dir, str(int(path_or_latest)))
        flat = safetensors.load_file(os.path.join(path, CHECKPOINT_NAME))
        self.state = load_train_state(self.state, flat, self.tx)
        logger.info("resumed from checkpoint step %d (%s)", self.state.step, path)

    def finalize_checkpoints(self):
        """Checkpoints are written synchronously: nothing to wait for (JAX
        waits for orbax's background writes here)."""

    def install_preemption_handler(self):
        """SIGTERM / SIGINT set a flag; the train loop checkpoints at the next
        step boundary and stops, instead of dying mid-write."""
        import signal

        self._preempted = False

        def _handler(signum, frame):
            logger.warning("signal %d received; will checkpoint and stop", signum)
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                break

    # ------------------------------------------------------------ eval
    def _eval_step(self, params, batch):
        if self.eval_fn is not None:
            return self.eval_fn(params, batch)
        assert self.loss_fn is not None, "evaluate() needs eval_fn or loss_fn"
        out = self.loss_fn(params, batch, torch.Generator(device=self.device).manual_seed(0))
        return {"loss": out[0] if isinstance(out, tuple) else out}

    def evaluate(self, eval_dataloader=None, prefix: str = "eval") -> Dict[str, float]:
        """A pass over the eval set under `torch.inference_mode`. Scalar
        outputs are averaged over the batches; array outputs are
        concatenated for `compute_metrics` (corpus metrics). The metrics go
        to the callbacks and come back as {f"{prefix}_{name}": float}."""
        loader = eval_dataloader or self.eval_dataloader
        assert loader is not None, "no eval_dataloader"
        params = self.state.params if self.state is not None else self.params
        sums: Dict[str, torch.Tensor] = {}
        collected: Dict[str, list] = {}
        n = 0
        with torch.inference_mode():
            for batch in loader:
                for k, v in self._eval_step(params, self._prepare_batch(batch)).items():
                    v = torch.as_tensor(v)
                    if v.ndim == 0:
                        sums[k] = sums.get(k, 0.0) + v.double()
                    else:
                        collected.setdefault(k, []).append(v.cpu().numpy())
                n += 1
        metrics = {f"{prefix}_{k}": float(v) / max(n, 1) for k, v in sums.items()}
        if self.compute_metrics is not None and collected:
            extra = self.compute_metrics({k: np.concatenate(v) for k, v in collected.items()})
            metrics.update({f"{prefix}_{k}": float(v) for k, v in extra.items()})
        step = self.state.step if self.state is not None else 0
        logger.info("eval @%d: %s", step, " ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
        for cb in self.callbacks:
            cb(step=step, metrics=metrics)
        return metrics

    def predict(self, dataloader, predict_fn) -> list:
        """predict_fn(params, batch) over `dataloader` under
        `torch.inference_mode`, each output brought to the host as numpy
        (tensors inside dicts, lists and tuples too)."""
        params = self.state.params if self.state is not None else self.params
        with torch.inference_mode():
            return [_to_numpy(predict_fn(params, self._prepare_batch(b))) for b in dataloader]

    def _maybe_eval_and_track_best(self, step: int):
        metrics = self.evaluate()
        a = self.args
        key = f"eval_{a.metric_for_best_model}"
        if key not in metrics:
            return
        val = metrics[key]
        better = (self.best_metric is None
                  or (val > self.best_metric if a.greater_is_better else val < self.best_metric))
        if better:
            self.best_metric, self.best_step = val, step
            logger.info("new best %s=%.4f at step %d", key, val, step)
            self.save_checkpoint(step)

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
        else the epochs), saving every `save_steps`, evaluating every
        `eval_steps` under `do_eval` (and at the end), stopping at a step
        boundary after a preemption signal (with a checkpoint); returns
        {"final_step": ..., the final eval's metrics, and the last step's
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
                if a.do_eval and a.eval_steps and step % a.eval_steps == 0 \
                        and self.eval_dataloader is not None:
                    self._maybe_eval_and_track_best(step)
                if self._preempted:
                    logger.warning("preemption: saving checkpoint at step %d", step)
                    self.save_checkpoint(step)
                    break
            if step >= total or self._preempted:
                break
        final_eval = {}
        if a.do_eval and self.eval_dataloader is not None and not self._preempted:
            final_eval = self.evaluate()
        self.finalize_checkpoints()
        return {"final_step": step, **final_eval, **{k: float(v) for k, v in metrics.items()}}


def _to_numpy(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_numpy(v) for v in out)
    return out


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
