"""CLIP contrastive pretraining (port of examples/train_clip.py).

The recipe: CLIP ViT-B/16 (`VITB16`) computing in bf16, the contrastive
loss over each batch, the worker-pool DataLoader, the Trainer's device
put-ahead, AdamW at 5e-4 with warmup min(200, max(steps // 10, 1)) and the
cosine schedule, clip 1.0, no weight decay. The port keeps fp32 master
weights (`CLIPModel(..., dtype=torch.bfloat16)` over fp32 parameters); the
example's `CLIPModel.from_config(VITB16, dtype=bf16)` casts the parameters
themselves to bf16, and optax then keeps bf16 moments.

The example decodes jpegs with PIL and preprocesses them with
CLIPImageProcessor inside the loader's workers; neither is ported yet, so
`ImageTextDataset` takes preprocessed NHWC float arrays and `main` raises
where the example would decode. `build_trainer` takes a model and a dataset
from the caller (e.g. `models.clip.vitb16.random_clip` and seeded arrays).
Checkpoints are not ported, so `save_steps` is 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..datasets import DataLoader
from ..models.clip import CLIPModel, clip_contrastive_loss
from ..models.clip.vitb16 import VITB16  # noqa: F401  (the recipe's config)
from ..trainer import Trainer, TrainingArguments


class ImageTextDataset:
    """(preprocessed pixels, caption) pairs -> {"pixel_values": (S, S, 3)
    float32, "input_ids": (77,) int32}; the tokenize call runs inside the
    DataLoader's workers, as the example's decode and preprocess do."""

    def __init__(self, items, tokenize):
        self.items = items          # [(pixels (S, S, 3) float array, caption str)]
        self.tokenize = tokenize

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        pixels, caption = self.items[i]
        return {"pixel_values": np.asarray(pixels, np.float32),
                "input_ids": self.tokenize(caption)}


def _hash_tokenize(caption, max_len=77, vocab=49408):
    """Stand-in tokenizer for runs without a vocab file (copy of the
    example's): start id vocab - 2, a word's id from Python's `hash` (salted
    per process), the eos id vocab - 1, padding 0."""
    ids = np.zeros(max_len, np.int32)
    words = caption.split()[: max_len - 2]
    ids[0] = vocab - 2
    for j, w in enumerate(words):
        ids[j + 1] = (hash(w) % (vocab - 3)) + 1
    ids[len(words) + 1] = vocab - 1
    return ids


def clip_loss_fn(model: CLIPModel):
    """The example's loss_fn(params, batch, rng): pixels cast to bf16, both
    towers, the contrastive loss. The params live in the model; `params`
    holds them by reference."""
    def loss_fn(params, batch, rng):
        img, txt, scale = model(batch["pixel_values"].to(torch.bfloat16), batch["input_ids"])
        return clip_contrastive_loss(img, txt, scale), {}

    return loss_fn


def build_trainer(model: CLIPModel, dataset, batch: int, max_steps: int) -> Trainer:
    """The example's loader and TrainingArguments around `model`: shuffled
    batches of `batch` from 8 workers 8 batches ahead, lr 5e-4, warmup
    min(200, max(max_steps // 10, 1)), `max_steps` steps, logging every 10,
    no checkpoints."""
    loader = DataLoader(dataset, batch_size=batch, shuffle=True, num_workers=8,
                        prefetch_batches=8)
    args = TrainingArguments(output_dir="output/clip", learning_rate=5e-4,
                             warmup_steps=min(200, max(max_steps // 10, 1)), max_steps=max_steps,
                             logging_steps=10, save_steps=0, benchmark=True)
    return Trainer(model=model, args=args, loss_fn=clip_loss_fn(model), train_dataloader=loader)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    raise NotImplementedError(
        f"train_clip {' '.join(argv)}: decoding jpegs and CLIPImageProcessor are not ported yet; "
        f"build an ImageTextDataset over preprocessed NHWC arrays and call build_trainer")


if __name__ == "__main__":
    main()
