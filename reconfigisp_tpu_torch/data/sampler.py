"""Samplers and loaders: the DARTS half-split and rank-strided iteration.

Counterpart of reconfigisp_tpu/data/sampler.py (reference
codes/data/data_sampler.py:69-150), kept as its own copy: the dataset's
first half feeds the weight step, the second half the alpha (val) step, each
with a per-epoch seeded permutation and rank-strided subsampling; the epoch
is enlarged by a ratio so epochs rarely roll over.  The index streams are
the JAX package's, draw for draw.  Batches are numpy, stacked by a
background prefetch thread that does numpy only and never touches CUDA; the
trainers move them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class HalfSplitSampler:
    """Infinite index iterator over one half of a dataset.

    :param half: 'train' (first half) or 'val' (second half)
        (reference data_sampler.py:85-87, 130-133)
    :param rank/world: process sharding stride (data_sampler.py:98-102)
    :param enlarge: epoch enlargement ratio (data_sampler.py:76, ratio=128)
    """

    def __init__(self, n_total: int, half: str = "train", *,
                 rank: int = 0, world: int = 1, enlarge: int = 128,
                 seed: int = 0, start_epoch: int = 0):
        lo, hi = (0, n_total // 2) if half == "train" else (n_total // 2, n_total)
        self.indices = np.arange(lo, hi)
        if len(self.indices) == 0:
            raise ValueError("empty sampler half")
        self.rank, self.world = rank, world
        self.enlarge = enlarge
        self.seed = seed
        # resumed runs restart at the saved epoch so per-epoch permutations
        # do not silently repeat from epoch 0 (reference train.py:165-169
        # tracks epoch across reshuffles)
        self.start_epoch = start_epoch

    @property
    def per_epoch_len(self) -> int:
        """Samples this rank sees per (enlarged) epoch."""
        return len(range(self.rank, len(self.indices) * self.enlarge,
                         self.world))

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        reps = np.concatenate([rng.permutation(self.indices)
                               for _ in range(self.enlarge)])
        return reps[self.rank::self.world]

    def __iter__(self) -> Iterator[int]:
        epoch = self.start_epoch
        while True:
            for i in self.epoch_indices(epoch):
                yield int(i)
            epoch += 1


def default_collate(samples) -> dict:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class Loader:
    """Batched iterator with optional background prefetch."""

    def __init__(self, dataset, sampler, batch_size: int,
                 collate: Callable = default_collate,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate = collate
        self.prefetch = prefetch

    def _produce(self):
        it = iter(self.sampler)
        while True:
            yield self.collate(
                [self.dataset[next(it)] for _ in range(self.batch_size)])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._produce()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for batch in self._produce():
                if stop.is_set():
                    return
                q.put(batch)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        # bind BEFORE yielding: at interpreter shutdown module globals may
        # already be None when generator cleanup runs this finally block,
        # and `except queue.Empty` would raise "catching classes that do
        # not inherit from BaseException"
        empty_exc = queue.Empty
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                q.get_nowait()
            except empty_exc:
                pass


def create_loader(dataset, batch_size: int, *, shuffle_seed: int = 0,
                  rank: int = 0, world: int = 1, start_epoch: int = 0,
                  skip: int = 0,
                  collate: Callable = default_collate) -> Loader:
    """Whole-dataset loader (fixed-pipeline training / test;
    reference data/__init__.py:26-28 uses bs=1 for test).

    :param skip: samples (per this rank) to drop from the front of the
        infinite stream — resumed fixed-pipeline runs pass
        step*batch so the data order continues exactly where the
        pre-resume run stopped instead of replaying its epochs."""

    class _All:
        def __init__(self, n, seed):
            self.n, self.seed = n, seed

        @property
        def per_epoch_len(self):
            return len(range(rank, self.n, world))

        def __iter__(self):
            epoch, to_skip = start_epoch, int(skip)
            while True:
                rng = np.random.default_rng(self.seed + epoch)
                idxs = rng.permutation(self.n)[rank::world]
                if to_skip >= len(idxs):
                    to_skip -= len(idxs)
                    epoch += 1
                    continue
                for i in idxs[to_skip:]:
                    yield int(i)
                to_skip = 0
                epoch += 1

    return Loader(dataset, _All(len(dataset), shuffle_seed), batch_size,
                  collate)


def create_search_loaders(dataset, batch_size: int, *, rank: int = 0,
                          world: int = 1, seed: int = 0, start_epoch: int = 0,
                          collate: Callable = default_collate):
    """(train_loader, val_loader) with the DARTS half-split
    (reference train.py:134-148)."""
    train = Loader(dataset,
                   HalfSplitSampler(len(dataset), "train", rank=rank,
                                    world=world, seed=seed,
                                    start_epoch=start_epoch),
                   batch_size, collate)
    val = Loader(dataset,
                 HalfSplitSampler(len(dataset), "val", rank=rank,
                                  world=world, seed=seed + 1,
                                  start_epoch=start_epoch),
                 batch_size, collate)
    return train, val
