"""TrainingArguments (port of paddlemix_tpu/trainer/arguments.py: the same
fields and defaults; the Trainer refuses the ones whose feature is not
ported)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "output"
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 0
    weight_decay: float = 0.0
    layer_decay: Optional[float] = None  # <1.0 enables per-layer LR decay
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    num_train_epochs: int = 1
    max_steps: int = -1
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    seed: int = 42
    bf16: bool = True
    data_parallel_degree: int = -1
    fsdp_parallel_degree: int = 1
    tensor_parallel_degree: int = 1
    sequence_parallel_degree: int = 1
    pipeline_parallel_degree: int = 1
    expert_parallel_degree: int = 1
    dataloader_num_workers: int = 4
    prefetch_depth: int = 2
    benchmark: bool = False
    profiler_options: Optional[str] = None
    report_to: str = "none"
    resume_from_checkpoint: Optional[str] = None
    do_eval: bool = False
    eval_steps: int = 0
    per_device_eval_batch_size: int = 8
    metric_for_best_model: str = "loss"
    greater_is_better: bool = False

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **overrides) -> "TrainingArguments":
        """The fields of `data` (and `overrides`); other keys are ignored, as
        the JAX BaseConfig keeps them aside."""
        data = dict(data, **overrides)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})
