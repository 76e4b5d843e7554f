"""Supervised fine-tuning entry point (port of
paddlemix_tpu/tools/supervised_finetune.py).

  python -m paddlemix_tpu_torch.tools.supervised_finetune config.json

reads the JSON config (model_name_or_path, dataset_path as jsonl with
input_ids/labels, max_length, mixtoken, lora + lora_rank/lora_r +
lora_alpha, recompute, and any TrainingArguments field), loads the model and
the dataset and runs `finetune`: recompute, MixToken packing, the
DataLoader, LoRA with a frozen base (or full fine-tuning), the Trainer. The
port cannot read a checkpoint yet, so `main` stops at loading the model;
`finetune` takes a model and a dataset from the caller (a model with seeded
random weights, e.g. `models.llama.random_llama`, and a seeded dataset).
Saving the LoRA factors (safetensors in JAX) is not ported yet either.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import sys
from typing import Any, Dict, Optional

import torch

from ..datasets import DataLoader, MixTokenMapDataset, load_dataset, pad_collate
from ..models.llava.modeling import llava_loss
from ..ops.attention import SegmentIds
from ..peft import LoraConfig, lora_init, lora_loss_fn, save_lora
from ..trainer import Trainer, TrainingArguments

logger = logging.getLogger(__name__)

# config keys that are not TrainingArguments fields but the tool reads
_TOOL_KEYS = ("model_name_or_path", "dataset_path", "max_length", "mixtoken", "pad_token_id",
              "lora", "lora_r", "lora_rank", "lora_alpha", "freeze", "freeze_include",
              "freeze_exclude", "warmup_ratio", "benchmark", "per_device_train_batch_size",
              "recompute", "gradient_checkpointing")


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


def build_trainer(model, dataset, cfg: Dict[str, Any]):
    """Everything `main` does after loading the model and the dataset, up to
    training: recompute, packing, the loader, LoRA (factors drawn from a
    generator seeded with the config's seed, on the model's device) or full
    fine-tuning. Returns (the Trainer, the LoraConfig or None)."""
    if cfg.get("recompute") or cfg.get("gradient_checkpointing"):
        enable_recompute(model)
    if cfg.get("mixtoken", True):
        dataset = MixTokenMapDataset(dataset, int(cfg.get("max_length", 2048)),
                                     pad_token_id=int(cfg.get("pad_token_id", 0)))
        logger.info("MixToken packing: %d packed rows", len(dataset))
    args = training_arguments(cfg)
    if args.pipeline_parallel_degree > 1:
        raise NotImplementedError("pipeline parallelism is not ported yet")
    loader = DataLoader(dataset, batch_size=int(cfg.get("per_device_train_batch_size", 8)),
                        collate_fn=pad_collate, shuffle=True, seed=args.seed)
    loss_fn = default_lm_loss(model)
    if not cfg.get("lora"):
        return Trainer(model=model, args=args, loss_fn=loss_fn, train_dataloader=loader), None
    lcfg = LoraConfig(r=int(cfg.get("lora_r", cfg.get("lora_rank", 8))),
                      lora_alpha=int(cfg.get("lora_alpha", 16)))
    device = next(model.parameters()).device
    lora = lora_init(model, lcfg, torch.Generator(device=device).manual_seed(args.seed))
    return Trainer(params=lora, args=args, loss_fn=lora_loss_fn(loss_fn, model),
                   train_dataloader=loader), lcfg


def finetune(model, dataset, cfg: Dict[str, Any], max_steps: Optional[int] = None):
    """`build_trainer`, then training for `max_steps` micro-batches (None: the
    config's max_steps, else its epochs). Returns (the train result, the
    Trainer, the LoraConfig or None)."""
    trainer, lcfg = build_trainer(model, dataset, cfg)
    return trainer.train(max_steps), trainer, lcfg


def load_model(cfg: Dict[str, Any]):
    raise NotImplementedError(f"supervised_finetune: reading the checkpoint "
                              f"{cfg.get('model_name_or_path')!r} is not ported yet; build the "
                              f"model (e.g. models.llama.random_llama) and call finetune")


def main(config_path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None):
    cfg = load_config(config_path or sys.argv[1], overrides)
    model = load_model(cfg)
    result, trainer, lcfg = finetune(model, load_dataset(cfg["dataset_path"]), cfg)
    if lcfg is not None:
        save_lora(trainer.state.params, lcfg, f"{trainer.args.output_dir}/lora")
    else:
        raise NotImplementedError("supervised_finetune: saving the model is not ported yet")
    return result


if __name__ == "__main__":
    main()
