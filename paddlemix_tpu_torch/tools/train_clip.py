"""CLIP contrastive pretraining (port of examples/train_clip.py).

The recipe: CLIP ViT-B/16 (`VITB16`) computing in bf16, the contrastive
loss over each batch, the worker-pool DataLoader, the Trainer's device
put-ahead, AdamW at 5e-4 with warmup min(200, max(steps // 10, 1)) and the
cosine schedule, clip 1.0, no weight decay. The port keeps fp32 master
weights (`CLIPModel(..., dtype=torch.bfloat16)` over fp32 parameters); the
example's `CLIPModel.from_config(VITB16, dtype=bf16)` casts the parameters
themselves to bf16, and optax then keeps bf16 moments.

The data plane is the example's: jpeg files -> PIL decode ->
`CLIPImageProcessor` (bicubic resize, centre crop, normalise; the fused C++
path with PMIX_NATIVE_PREPROCESS=1) -> tokenizer, inside the DataLoader's
workers, then the Trainer's device put-ahead. `main(["--synthetic"])`
generates 256 jpegs (640 x 480, seeded noise) in a temporary directory,
removed after the run; CLIP_STEPS (default 20 synthetic, 10,000 otherwise)
and CLIP_BATCH (default 64) size the run; a vocab.json (its directory holding
merges.txt) as the third argument selects the BPE tokenizer, else the hash
tokenizer. Checkpoints are not ported, so `save_steps` is 0.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch
from PIL import Image

from ..datasets import DataLoader
from ..models.clip import CLIPModel, CLIPTokenizer, clip_contrastive_loss
from ..models.clip.vitb16 import VITB16, random_clip  # noqa: F401  (the recipe's config)
from ..processors.clip_processing import CLIPImageProcessor
from ..trainer import Trainer, TrainingArguments


class ImageTextDataset:
    """(image, caption) pairs -> {"pixel_values": (S, S, 3) float32,
    "input_ids": (77,) int32}. An image is a file path, decoded by PIL and
    preprocessed by `processor`, or (`processor` None) an array already
    preprocessed. Decode, preprocess and tokenize run here, inside the
    DataLoader's workers, so that host work overlaps the card's."""

    def __init__(self, items, processor, tokenize):
        self.items = items          # [(path or (S, S, 3) array, caption str)]
        self.processor = processor
        self.tokenize = tokenize

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        image, caption = self.items[i]
        if self.processor is None:
            pixels = np.asarray(image, np.float32)
        else:
            with Image.open(image) as im:
                pixels = self.processor(im.convert("RGB"))["pixel_values"][0]
        return {"pixel_values": pixels.astype(np.float32, copy=False),
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


def synthetic_items(root, n=256):
    """n jpegs of seeded noise, 640 x 480, each the first rolled, with
    captions (the example's `_synthetic_items`)."""
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    base = rng.randint(0, 255, (480, 640, 3), np.uint8)
    items = []
    for i in range(n):
        p = os.path.join(root, f"syn_{i:04d}.jpg")
        if not os.path.exists(p):
            Image.fromarray(np.roll(base, i * 11, axis=1)).save(p, quality=88)
        items.append((p, f"synthetic image number {i} of rolled noise"))
    return items


def _vocab_tokenize(path):
    """The example's BPE ids: the first 77 of `encode` (no start or end
    token), padded with 0; `path` a vocab.json or its directory."""
    tok = CLIPTokenizer.from_pretrained(path if os.path.isdir(path) else os.path.dirname(path))

    def tokenize(caption):
        ids = np.asarray(tok.encode(caption)[:77], np.int32)
        return np.pad(ids, (0, 77 - len(ids)))
    return tokenize


def main(argv=None, device="cuda"):
    """The example's run: `--synthetic`, or IMAGE_ROOT CAPTIONS_TSV [VOCAB]
    (captions.tsv: one "filename<TAB>caption" a line). Trains a seeded random
    ViT-B/16 CLIP on `device`; returns the Trainer's result (final step and
    the last step's metrics)."""
    argv = sys.argv[1:] if argv is None else argv
    tmp = None
    try:
        if "--synthetic" in argv:
            tmp = tempfile.mkdtemp(prefix="clip_synth_jpegs_")
            items, tokenize = synthetic_items(tmp), _hash_tokenize
            max_steps = int(os.environ.get("CLIP_STEPS", 20))
        else:
            image_root, captions_tsv = argv[0], argv[1]
            with open(captions_tsv) as f:
                items = [(os.path.join(image_root, a), b.strip()) for a, b in
                         (line.split("\t", 1) for line in f if "\t" in line)]
            tokenize = _vocab_tokenize(argv[2]) if len(argv) > 2 else _hash_tokenize
            max_steps = int(os.environ.get("CLIP_STEPS", 10000))
        model = random_clip(device, seed=0)
        data = ImageTextDataset(items, CLIPImageProcessor(), tokenize)
        trainer = build_trainer(model, data, int(os.environ.get("CLIP_BATCH", 64)), max_steps)
        return trainer.train()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
