"""Deterministic batch loading (counterpart of
``deepspeed_tpu/runtime/dataloader.py``): global host batches of numpy
arrays, in the same seeded per-epoch order as the JAX package's loader;
the engine moves each to the device."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


class RepeatingLoader:
    """Wraps an iterable to restart it on StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def default_collate(samples: Sequence[Any]):
    """Stack a list of sample trees (dicts / tuples of arrays) into one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batches an indexable dataset into global train batches, shuffled per
    epoch by ``RandomState(seed + epoch).permutation``."""

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.len = len(dataset) // batch_size  # the last partial batch is dropped

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        for b in range(self.len):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1
