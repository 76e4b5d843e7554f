"""Supervised fine-tuning entry point (port of
paddlemix_tpu/tools/supervised_finetune.py).

  python -m paddlemix_tpu_torch.tools.supervised_finetune config.json

reads the JSON config (model_name_or_path, dataset_path as jsonl with
input_ids/labels, max_length, mixtoken, lora + lora_rank/lora_r +
lora_alpha, recompute, bf16, warmup_ratio and any TrainingArguments field),
loads the model through `AutoModel.from_pretrained` (bf16 unless `bf16` is
false) and the dataset, and runs `finetune`: recompute, MixToken packing,
the DataLoader, LoRA with a frozen base (or full fine-tuning), the Trainer
(checkpoints, resume, evaluation). It then saves `output_dir/lora` (the
adapter, as JAX's `save_lora` writes it) or `output_dir/final` (the model,
as `save_pretrained`). A LLaVA checkpoint trains its language model (the
JAX loss would feed the packed positions to LLaVA as pixel values) and a
log line says so; a full fine-tune saves the whole LLaVA. Two keys are the
port's own: `eval_dataset_path` (a held-out jsonl, packed as the training
set, evaluated when `do_eval`) and `device` ("cuda" by default; "cpu" for
tests).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import sys
from typing import Any, Dict, Optional

import torch

from ..auto import AutoModel
from ..core.modeling import save_pretrained
from ..datasets import DataLoader, MixTokenMapDataset, load_dataset, pad_collate
from ..models.llava.modeling import LlavaForConditionalGeneration, llava_loss
from ..ops.attention import SegmentIds
from ..peft import LoraConfig, lora_init, lora_loss_fn, save_lora
from ..trainer import Trainer, TrainingArguments

logger = logging.getLogger(__name__)

# config keys that are not TrainingArguments fields but the tool reads
_TOOL_KEYS = ("model_name_or_path", "dataset_path", "max_length", "mixtoken", "pad_token_id",
              "lora", "lora_r", "lora_rank", "lora_alpha", "freeze", "freeze_include",
              "freeze_exclude", "warmup_ratio", "benchmark", "per_device_train_batch_size",
              "recompute", "gradient_checkpointing", "eval_dataset_path", "device")


def freeze_params(model: torch.nn.Module, include: Optional[str] = None,
                  exclude: Optional[str] = None) -> Dict[str, bool]:
    """Trainable mask by name: include = regex of params to freeze, exclude =
    regex of params kept trainable even so."""
    mask = {}
    for name, _ in model.named_parameters():
        frozen = bool(include and re.search(include, name))
        if exclude and re.search(exclude, name):
            frozen = False
        mask[name] = not frozen
    return mask


def enable_recompute(model) -> None:
    """Per-layer recompute in the backward (the reference's `recompute`)."""
    if hasattr(model.config, "gradient_checkpointing"):
        model.config.gradient_checkpointing = True
    else:
        logger.warning("%s has no gradient_checkpointing hook; recompute ignored",
                       type(model).__name__)


def default_lm_loss(model):
    """loss_fn(params, batch, rng): the shifted LM loss of the model's logits
    over a packed batch (segment ids and positions when the batch has them).
    The params live in the model; `params` holds them by reference."""
    def loss_fn(params, batch, rng):
        seg = positions = None
        if "segment_ids" in batch:
            seg = SegmentIds(batch["segment_ids"], batch["segment_ids"])
            positions = batch.get("positions")
        logits, _ = model(batch["input_ids"], positions, segment_ids=seg)
        return llava_loss(logits, batch["labels"])

    return loss_fn


def load_config(config_path: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    with open(config_path) as f:
        cfg = json.load(f)
    cfg.update(overrides or {})
    return cfg


def training_arguments(cfg: Dict[str, Any]) -> TrainingArguments:
    """The TrainingArguments of a config, with warmup_ratio resolved."""
    fields = {f.name for f in dataclasses.fields(TrainingArguments)}
    unknown = {k for k in cfg if k not in fields and k not in _TOOL_KEYS}
    if unknown:
        logger.warning("ignoring unknown config keys: %s", sorted(unknown))
    args = TrainingArguments.from_dict({k: v for k, v in cfg.items() if k in fields})
    if cfg.get("warmup_ratio") and not cfg.get("warmup_steps"):
        horizon = args.max_steps if args.max_steps > 0 else 1000
        args.warmup_steps = int(float(cfg["warmup_ratio"]) * horizon)
    return args


def _packed(dataset, cfg: Dict[str, Any]):
    if not cfg.get("mixtoken", True):
        return dataset
    packed = MixTokenMapDataset(dataset, int(cfg.get("max_length", 2048)),
                                pad_token_id=int(cfg.get("pad_token_id", 0)))
    logger.info("MixToken packing: %d packed rows", len(packed))
    return packed


def build_trainer(model, dataset, cfg: Dict[str, Any], eval_dataset=None):
    """Everything `main` does after loading the model and the dataset, up to
    training: recompute, packing, the loaders (the eval set's, packed alike,
    in order, at `per_device_eval_batch_size`), LoRA (factors drawn from a
    generator seeded with the config's seed, on the model's device) or full
    fine-tuning. Returns (the Trainer, the LoraConfig or None)."""
    if cfg.get("recompute") or cfg.get("gradient_checkpointing"):
        enable_recompute(model)
    dataset = _packed(dataset, cfg)
    args = training_arguments(cfg)
    if args.pipeline_parallel_degree > 1:
        raise NotImplementedError("pipeline parallelism is not ported yet")
    loader = DataLoader(dataset, batch_size=int(cfg.get("per_device_train_batch_size", 8)),
                        collate_fn=pad_collate, shuffle=True, seed=args.seed)
    eval_loader = None if eval_dataset is None else DataLoader(
        _packed(eval_dataset, cfg), batch_size=args.per_device_eval_batch_size,
        collate_fn=pad_collate)
    loss_fn = default_lm_loss(model)
    if not cfg.get("lora"):
        return Trainer(model=model, args=args, loss_fn=loss_fn, train_dataloader=loader,
                       eval_dataloader=eval_loader), None
    lcfg = LoraConfig(r=int(cfg.get("lora_r", cfg.get("lora_rank", 8))),
                      lora_alpha=int(cfg.get("lora_alpha", 16)))
    device = next(model.parameters()).device
    lora = lora_init(model, lcfg, torch.Generator(device=device).manual_seed(args.seed))
    return Trainer(params=lora, args=args, loss_fn=lora_loss_fn(loss_fn, model),
                   train_dataloader=loader, eval_dataloader=eval_loader), lcfg


def finetune(model, dataset, cfg: Dict[str, Any], max_steps: Optional[int] = None,
             eval_dataset=None):
    """`build_trainer`, then training for `max_steps` micro-batches (None: the
    config's max_steps, else its epochs). Returns (the train result, the
    Trainer, the LoraConfig or None)."""
    trainer, lcfg = build_trainer(model, dataset, cfg, eval_dataset)
    return trainer.train(max_steps), trainer, lcfg


def load_model(cfg: Dict[str, Any]):
    """`AutoModel.from_pretrained(model_name_or_path)` in bf16 (fp32 when the
    config's `bf16` is false) on the config's `device` (the card by
    default)."""
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    return AutoModel.from_pretrained(cfg["model_name_or_path"], dtype=dtype,
                                     device=cfg.get("device", "cuda"))


def main(config_path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None):
    cfg = load_config(config_path or sys.argv[1], overrides)
    model = load_model(cfg)
    trained = model
    if isinstance(model, LlavaForConditionalGeneration):
        trained = model.language_model
        logger.info("LLaVA checkpoint: training its language model (%d layers); the vision "
                    "tower and projector stay as loaded", trained.config.num_hidden_layers)
    eval_set = load_dataset(cfg["eval_dataset_path"]) if cfg.get("eval_dataset_path") else None
    result, trainer, lcfg = finetune(trained, load_dataset(cfg["dataset_path"]), cfg,
                                     eval_dataset=eval_set)
    out = trainer.args.output_dir
    if lcfg is not None:
        save_lora(trainer.state.params, lcfg, f"{out}/lora", key_map=trained.flax_key_map)
        logger.info("saved LoRA adapters to %s/lora", out)
    else:
        save_pretrained(model, f"{out}/final")
        logger.info("saved model to %s/final", out)
    return result


if __name__ == "__main__":
    main()
