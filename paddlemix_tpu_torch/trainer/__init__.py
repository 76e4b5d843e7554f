"""Training on one card (port of paddlemix_tpu/trainer without the mesh)."""

from .arguments import TrainingArguments
from .callbacks import (
    BenchmarkCallback,
    ProfilerCallback,
    TensorBoardCallback,
    parse_profiler_options,
)
from .ema import EMAState, ema_init, ema_update
from .train_state import (
    TrainState,
    create_train_state,
    load_train_state,
    make_train_step,
    train_state_dict,
)
from .trainer import MeshAwareLoss, Trainer

__all__ = ["BenchmarkCallback", "EMAState", "MeshAwareLoss", "ProfilerCallback",
           "TensorBoardCallback", "TrainState", "Trainer", "TrainingArguments",
           "create_train_state", "ema_init", "ema_update", "load_train_state",
           "make_train_step", "parse_profiler_options", "train_state_dict"]
