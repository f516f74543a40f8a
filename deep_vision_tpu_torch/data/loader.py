"""Host batching: static-shape eval padding, ``ArrayLoader`` and the
per-sample-prep ``PreppedSampleLoader``.

Copies of ``pad_eval_indices``, ``PreppedSampleLoader`` and
``ArrayLoader`` from ``deep_vision_tpu/data/loader.py``.
"""

from __future__ import annotations

from collections import deque
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


# worker-side state of a PreppedSampleLoader pool, set once per worker
# process by the pool initializer; the inline path calls PREPARE with the
# same per-item rng, so pooled and inline iteration give identical batches
_PREP_WORKER: dict = {}


def _prep_worker_init(cfg: dict):
    # one intra-op thread per worker: the pool is the parallelism
    import torch

    torch.set_num_threads(1)
    _PREP_WORKER.update(cfg)


def _prep_one(args: tuple) -> dict:
    i, epoch = args
    w = _PREP_WORKER
    rng = np.random.default_rng((w["seed"], epoch, int(i)))
    return w["prepare"](w["samples"][i], rng, **w["kwargs"])


class PreppedSampleLoader:
    """Batches of per-sample-prepared items (detection): epoch shuffling
    from ``default_rng((seed, epoch))``, static eval padding with a
    ``weight`` row mask, and a per-item augmentation rng
    ``default_rng((seed, epoch, index))``, so a batch does not depend on
    iteration order or worker count.  With ``num_workers > 0`` a
    forkserver pool prepares ``prefetch_batches`` batches ahead.

    Subclasses set ``PREPARE`` to a module-level (picklable) function
    ``prepare(sample, rng, **kwargs)`` and implement ``_prep_kwargs``;
    their own fields must be set BEFORE ``super().__init__`` (the pool
    snapshots ``_prep_kwargs()``)."""

    PREPARE: Callable

    def __init__(self, samples, batch_size: int, train: bool, seed: int,
                 num_workers: int = 0, prefetch_batches: int = 2):
        self.samples = samples
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0
        self._pool = None
        if num_workers > 0:
            import multiprocessing as mp

            # forkserver, not fork: the trainer's process has live threads
            # (CUDA, the prefetcher) by the time a loader is built
            self._pool = mp.get_context("forkserver").Pool(
                num_workers, initializer=_prep_worker_init,
                initargs=(dict(samples=samples, seed=seed,
                               prepare=type(self).PREPARE,
                               kwargs=self._prep_kwargs()),))

    def _prep_kwargs(self) -> dict:
        raise NotImplementedError

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        full = len(self.samples) // self.batch_size
        if not self.train and len(self.samples) % self.batch_size:
            return full + 1  # eval covers the full set (padded last batch)
        return full

    def _prepare_indexed(self, i: int, epoch: int) -> dict:
        rng = np.random.default_rng((self.seed, epoch, int(i)))
        return type(self).PREPARE(self.samples[i], rng,
                                  **self._prep_kwargs())

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _assemble(self, items: list, weight) -> dict:
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        if not self.train:
            batch["weight"] = weight
        return batch

    def __iter__(self) -> Iterator[dict]:
        order = np.random.default_rng((self.seed, self.epoch))
        idx = np.arange(len(self.samples))
        if self.train:
            order.shuffle(idx)
        plan = [pad_eval_indices(idx, b * self.batch_size, self.batch_size)
                for b in range(len(self))]
        if self._pool is None:
            for sel, weight, _ in plan:
                yield self._assemble(
                    [self._prepare_indexed(int(i), self.epoch)
                     for i in sel], weight)
            return
        chunk = max(1, self.batch_size // (2 * self.num_workers))
        pending: deque = deque()
        submit = 0
        for b in range(len(plan)):
            while submit < len(plan) and len(pending) < \
                    self.prefetch_batches:
                args = [(int(i), self.epoch) for i in plan[submit][0]]
                pending.append(self._pool.map_async(_prep_one, args,
                                                    chunksize=chunk))
                submit += 1
            # a hung worker fails the epoch instead of pinning it
            yield self._assemble(pending.popleft().get(timeout=600.0),
                                 plan[b][1])


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
