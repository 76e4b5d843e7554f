"""MixToken sample packing (port of paddlemix_tpu/datasets/mixtoken.py): pack
tokenized samples into max_length rows that carry segment ids and positions,
which restart in every sample, so that attention keeps the samples apart."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

from .dataset import MapDataset

IGNORE_INDEX = -100


def pack_samples(samples: Iterable[Dict[str, Sequence[int]]], max_length: int,
                 pad_token_id: int = 0,
                 drop_last_incomplete: bool = False) -> List[Dict[str, np.ndarray]]:
    """samples: dicts with 1-D `input_ids` (+ optional `labels`). Returns rows
    with input_ids, labels, segment_ids (1-based; 0 = padding), positions
    (restarting at 0 in each sample; -1 at padding), attention_mask; each
    int32 of max_length. A sample that does not fit the current row starts
    the next; samples longer than max_length are cut."""
    rows: List[Dict[str, np.ndarray]] = []
    ids_, labels_, seg_, pos_ = [], [], [], []
    seg = 1

    def flush():
        nonlocal seg
        if not ids_:
            return
        pad = max_length - len(ids_)
        rows.append({
            "input_ids": np.asarray(ids_ + [pad_token_id] * pad, np.int32),
            "labels": np.asarray(labels_ + [IGNORE_INDEX] * pad, np.int32),
            "segment_ids": np.asarray(seg_ + [0] * pad, np.int32),
            "positions": np.asarray(pos_ + [-1] * pad, np.int32),
            "attention_mask": np.asarray([1] * len(ids_) + [0] * pad, np.int32),
        })
        for buf in (ids_, labels_, seg_, pos_):
            buf.clear()
        seg = 1

    for sample in samples:
        ids = list(sample["input_ids"])[:max_length]
        labels = list(sample.get("labels", ids))[:max_length]
        if len(ids_) + len(ids) > max_length:
            flush()
        ids_.extend(ids)
        labels_.extend(labels)
        seg_.extend([seg] * len(ids))
        pos_.extend(range(len(ids)))
        seg += 1
    if not drop_last_incomplete:
        flush()
    return rows


class MixTokenMapDataset(MapDataset):
    def __init__(self, dataset: Iterable, max_length: int, pad_token_id: int = 0):
        super().__init__(pack_samples(dataset, max_length, pad_token_id))
