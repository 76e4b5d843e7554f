"""Trainer callbacks: benchmark telemetry, TensorBoard, the profiler (port of
paddlemix_tpu/trainer/callbacks.py). Callbacks receive (step, metrics) from
`Trainer.train` at each logging step and from `Trainer.evaluate`."""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


class BenchmarkCallback:
    """ips / device-memory telemetry with a warmup skip (the reference skips
    4 warmup steps). Memory is the card's allocator's (`bytes_in_use`,
    `peak_bytes_in_use` as JAX names them); on the CPU there is none."""

    def __init__(self, skip_steps: int = 4, log_every: int = 10):
        self.skip_steps = skip_steps
        self.log_every = log_every
        self.records = []

    def __call__(self, step: int, metrics: Dict):
        if step <= self.skip_steps:
            return
        rec = {"step": step, "ips": float(metrics.get("ips", 0.0)),
               "loss": float(metrics.get("loss", 0.0))}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            rec["bytes_in_use"] = torch.cuda.memory_allocated()
            rec["peak_bytes_in_use"] = torch.cuda.max_memory_allocated()
        self.records.append(rec)
        if step % self.log_every == 0 and rec.get("peak_bytes_in_use"):
            logger.info("benchmark step %d ips: %.3f peak_mem: %.2f GB", step, rec["ips"],
                        rec["peak_bytes_in_use"] / 2 ** 30)

    def summary(self) -> Dict:
        if not self.records:
            return {}
        ips = [r["ips"] for r in self.records]
        return {"mean_ips": sum(ips) / len(ips), "max_ips": max(ips), "steps": len(self.records)}


class TensorBoardCallback:
    """Scalars to TensorBoard through tensorboardX, imported here as JAX does:
    where it is not installed, building the callback (`report_to=
    "tensorboard"`) raises ImportError naming it."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError(f"report_to='tensorboard' needs the tensorboardX package, "
                              f"which is not installed ({e})") from e
        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir)

    def __call__(self, step: int, metrics: Dict):
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError, RuntimeError):  # arrays are no scalars
                pass

    def close(self):
        self.writer.close()


class ProfilerCallback:
    """`torch.profiler` over a step window (the reference's --profiler_options
    'batch_range=[10,20]'): started at `start_step`, stopped at `end_step`,
    where it writes a Chrome trace to `log_dir/trace.json`. It records the
    host and, where a card is present, the card's kernels (CUDA activity)."""

    def __init__(self, log_dir: str, start_step: int = 10, end_step: int = 20):
        self.log_dir = log_dir
        self.start_step = start_step
        self.end_step = end_step
        self.prof = None
        self.trace_path = os.path.join(log_dir, "trace.json")

    def __call__(self, step: int, metrics: Dict):
        from torch.profiler import ProfilerActivity, profile

        if step == self.start_step and self.prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
            logger.info("profiler trace started -> %s", self.log_dir)
        elif step >= self.end_step and self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.prof.export_chrome_trace(self.trace_path)
            self.prof = None
            logger.info("profiler trace written to %s", self.trace_path)


def parse_profiler_options(spec: Optional[str]) -> Optional[ProfilerCallback]:
    """Parse the reference's 'batch_range=[10,20];profile_path=...' flag."""
    if not spec:
        return None
    opts = dict(kv.split("=", 1) for kv in spec.split(";") if "=" in kv)
    rng = opts.get("batch_range", "[10,20]").strip("[]").split(",")
    return ProfilerCallback(opts.get("profile_path", "profile"), int(rng[0]), int(rng[1]))
