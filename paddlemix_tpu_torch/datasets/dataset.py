"""MapDataset and jsonl/json loading (port of paddlemix_tpu/datasets/dataset.py:
the parts the SFT path runs; the dataset registry, its recipes and
MapDataset's map/filter/shard/shuffle/select are not ported)."""

from __future__ import annotations

import json
import os
from typing import Any, Sequence


class MapDataset:
    def __init__(self, data: Sequence[Any]):
        self.data = list(data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def __iter__(self):
        return iter(self.data)


def load_dataset(name_or_path: str) -> MapDataset:
    """A .jsonl (one sample a line) or .json (a list) file."""
    if os.path.isfile(name_or_path):
        if name_or_path.endswith(".jsonl"):
            with open(name_or_path) as f:
                return MapDataset([json.loads(line) for line in f if line.strip()])
        if name_or_path.endswith(".json"):
            with open(name_or_path) as f:
                return MapDataset(json.load(f))
    raise ValueError(f"unknown dataset {name_or_path!r} (the port reads .jsonl and .json files; "
                     f"the JAX package's registry of named datasets is not ported)")
