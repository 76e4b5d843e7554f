"""Datasets, MixToken packing and batching (port of paddlemix_tpu/datasets,
the parts the SFT path runs)."""

from .collator import DataLoader, pad_collate, stack_collate
from .dataset import MapDataset, load_dataset
from .mixtoken import IGNORE_INDEX, MixTokenMapDataset, pack_samples

__all__ = ["DataLoader", "IGNORE_INDEX", "MapDataset", "MixTokenMapDataset", "load_dataset",
           "pack_samples", "pad_collate", "stack_collate"]
