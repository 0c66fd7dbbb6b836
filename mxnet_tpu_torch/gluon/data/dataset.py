"""Datasets: indexable collections of samples.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py``'s ``Dataset`` (with
``filter``, ``shard``, ``take``, ``transform`` and ``transform_first``),
``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset`` (the
records of a ``.rec`` file through its ``.idx``).
"""
from __future__ import annotations

import threading

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn`` is true."""
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` contiguous shards (the first
        ``len % num_shards`` one longer)."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} not in [0, {num_shards})")
        length = len(self)
        shard_len, rest = divmod(length, num_shards)
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        return SimpleDataset([self[i]
                              for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        """``fn(*sample)`` of each sample; computed on access where
        ``lazy``, else now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` of each sample's first element, the rest as they are."""
        return self.transform(_TransformFirst(fn), lazy)


class _TransformFirst:
    # a class, not a closure, so that a dataset pickles to a worker
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    """A dataset over a list (or anything indexable with a length)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Samples zipped from arrays of one length (numpy arrays, lists or
    NDArrays; a one-dimensional NDArray is read as numpy, as in the JAX
    package)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; 0-th has "
                    f"{self._length} while {i}-th has {len(data)}.")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of ``filename`` (a ``.rec`` file) in the order of its
    ``.idx`` file: each sample the record's bytes. Reads are serialised,
    so the threads of a ``DataLoader(thread_pool=True)`` share one open
    file; a worker process reopens it."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self.idx_file = filename.rsplit(".", 1)[0] + ".idx"
        self.filename = filename
        self._record = MXIndexedRecordIO(self.idx_file, self.filename, "r")
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

    def __getstate__(self):
        d = dict(self.__dict__)
        del d["_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()
