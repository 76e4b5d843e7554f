"""Parameter-efficient fine-tuning (port of paddlemix_tpu/peft: LoRA)."""

from .lora import (
    DEFAULT_TARGETS,
    LoraConfig,
    LoraDelta,
    lora_init,
    lora_loss_fn,
    lora_params,
    save_lora,
)

__all__ = ["DEFAULT_TARGETS", "LoraConfig", "LoraDelta", "lora_init", "lora_loss_fn",
           "lora_params", "save_lora"]
