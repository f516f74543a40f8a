"""In-memory batching: static-shape eval padding and ``ArrayLoader``.

Copies of ``pad_eval_indices`` and ``ArrayLoader`` from
``deep_vision_tpu/data/loader.py``.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np


def pad_eval_indices(idx: np.ndarray, start: int, batch_size: int
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """Slice ``idx[start:start+batch_size]``, pad a short tail by
    repeating the first index, and return ``(sel, weight, n_real)`` where
    ``weight`` is the 0/1 mask tasks use to ignore the filler rows."""
    sel = idx[start:start + batch_size]
    n_real = len(sel)
    if 0 < n_real < batch_size:
        sel = np.concatenate([sel, np.repeat(idx[:1], batch_size - n_real)])
    weight = np.zeros(batch_size, np.float32)
    weight[:n_real] = 1.0
    return sel, weight, n_real


class ArrayLoader:
    """In-memory dict-of-arrays dataset → shuffled fixed-size batches.

    The epoch-seeded reshuffle mirrors ``DataLoader(shuffle=True)``;
    ``drop_last=True`` keeps shapes static; ``pad_last`` pads the last
    batch with weight-0 fillers instead."""

    def __init__(self, data: dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 pad_last: bool = False,
                 transform: Callable[[dict, np.random.Generator], dict]
                 | None = None):
        self.data = data
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"length mismatch on '{k}': {len(v)} != {n}")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.epoch = 0
        self.transform = transform

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        end = (self.n // self.batch_size) * self.batch_size \
            if self.drop_last else self.n
        for start in range(0, end, self.batch_size):
            if self.pad_last:
                sel, weight, _ = pad_eval_indices(idx[:end], start,
                                                  self.batch_size)
            else:
                sel = idx[start:start + self.batch_size]
            batch = {k: v[sel] for k, v in self.data.items()}
            if self.pad_last:
                batch["weight"] = weight
            if self.transform is not None:
                batch = self.transform(batch, rng)
            yield batch
