"""Parameter-efficient fine-tuning (port of paddlemix_tpu/peft: LoRA)."""

from .lora import (
    DEFAULT_TARGETS,
    LoraConfig,
    LoraDelta,
    attach_lora,
    load_lora,
    lora_init,
    lora_loss_fn,
    lora_params,
    merge_lora_into_model,
    save_lora,
)

__all__ = ["DEFAULT_TARGETS", "LoraConfig", "LoraDelta", "attach_lora", "load_lora", "lora_init",
           "lora_loss_fn", "lora_params", "merge_lora_into_model", "save_lora"]
