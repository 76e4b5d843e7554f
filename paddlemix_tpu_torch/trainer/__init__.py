"""Training on one card (port of paddlemix_tpu/trainer without the mesh)."""

from .arguments import TrainingArguments
from .train_state import TrainState, create_train_state, make_train_step
from .trainer import MeshAwareLoss, Trainer

__all__ = ["MeshAwareLoss", "TrainState", "Trainer", "TrainingArguments", "create_train_state",
           "make_train_step"]
