"""Samplers: the orders in which a DataLoader visits a dataset.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py``. ``RandomSampler``
shuffles with numpy's global generator, as the JAX package does (so
``numpy.random.seed`` fixes both), or with the ``numpy.random.RandomState``
it is given. ``BatchSampler``'s ``last_batch`` is ``"keep"`` (a short last
batch), ``"discard"`` (none) or ``"rollover"`` (the rest opens the next
epoch's first batch).
"""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start, start + 1, ..., start + length - 1``."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation of ``range(length)``, new each epoch."""

    def __init__(self, length, generator=None):
        self._length = length
        self._rng = generator

    def __iter__(self):
        indices = onp.arange(self._length)
        (self._rng or onp.random).shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


_LAST = ("keep", "discard", "rollover")


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler``."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST:
            raise ValueError(f"last_batch must be one of 'keep', 'discard', "
                             f"or 'rollover', but got {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
