"""Batch collators and the shuffling DataLoader (port of
paddlemix_tpu/datasets/collator.py): numpy batches, the same order as the
JAX package's for the same seed."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np


def stack_collate(batch: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack same-shaped fields."""
    return {k: np.stack([np.asarray(s[k]) for s in batch]) for k in batch[0]}


def pad_collate(batch: Sequence[Dict[str, Any]], pad_token_id: int = 0,
                ignore_index: int = -100,
                pad_to_multiple_of: Optional[int] = 64) -> Dict[str, np.ndarray]:
    """Right-pad the token fields to the longest sample, rounded up to a
    multiple of `pad_to_multiple_of`; padding ids, ignored labels, mask 0,
    position -1, segment 0."""
    out: Dict[str, np.ndarray] = {}
    token_keys = [k for k in batch[0] if k in
                  ("input_ids", "labels", "attention_mask", "positions", "segment_ids")]
    max_len = max(len(np.asarray(s[token_keys[0]]).reshape(-1)) for s in batch)
    if pad_to_multiple_of:
        max_len = -(-max_len // pad_to_multiple_of) * pad_to_multiple_of
    fills = {"input_ids": pad_token_id, "labels": ignore_index,
             "attention_mask": 0, "positions": -1, "segment_ids": 0}
    for k in batch[0]:
        if k in token_keys:
            rows = [np.pad(np.asarray(s[k]).reshape(-1),
                           (0, max_len - len(np.asarray(s[k]).reshape(-1))),
                           constant_values=fills[k]) for s in batch]
            out[k] = np.stack(rows).astype(np.int32)
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in batch])
    if "attention_mask" not in out and "input_ids" in out:
        out["attention_mask"] = (out["input_ids"] != pad_token_id).astype(np.int32)
    return out


class DataLoader:
    """Batches of a MapDataset, shuffled per epoch by
    np.random.RandomState(seed + epoch) as the JAX package shuffles, with an
    optional thread pool that fetches and collates ahead."""

    def __init__(self, dataset, batch_size: int, collate_fn=stack_collate,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = max(prefetch_batches, num_workers or 1)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _chunks(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
            self._epoch += 1
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield chunk

    def _fetch(self, chunk):
        return self.collate_fn([self.dataset[j] for j in chunk])

    def __iter__(self):
        if not self.num_workers:
            for chunk in self._chunks():
                yield self._fetch(chunk)
            return
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            futs = collections.deque()
            chunks = self._chunks()
            for chunk in chunks:
                futs.append(pool.submit(self._fetch, chunk))
                if len(futs) >= self.prefetch_batches:
                    break
            while futs:
                batch = futs.popleft().result()
                nxt = next(chunks, None)
                if nxt is not None:
                    futs.append(pool.submit(self._fetch, nxt))
                yield batch
