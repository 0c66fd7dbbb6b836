"""``IntervalSampler``: counterpart of
``mxnet_tpu/gluon/contrib/data/sampler.py``."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """``i, i + interval, i + 2 * interval, ...`` for each start ``i``
    below ``interval`` (with ``rollover``; else only from 0): the
    strided order of truncated-BPTT language-model batches."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, \
            f"interval {interval} must not be larger than length {length}"
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return (self._length + self._interval - 1) // self._interval
