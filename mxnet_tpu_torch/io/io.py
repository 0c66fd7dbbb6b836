"""Data iterators.

Counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (pad, discard, roll_over; the same shuffle
order as the JAX package for one seed), ``ResizeIter``,
``PrefetchingIter`` (a background thread), ``MNISTIter`` (idx files,
plain or gzipped) and ``CSVIter``. ``NDArrayIter`` holds its arrays on
the context current at construction and gathers each batch there; a
Module moves each batch to its executors' device. The record
iterators (``ImageRecordIter``, ``ImageDetRecordIter``, ``LibSVMIter``,
``MXDataIter``) raise ``NotImplementedError``: they wait with the native
record reader (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import namedtuple

import numpy as onp
import torch

from ..context import Context
from ..ndarray.ndarray import NDArray, _wrap, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MXDataIter", "ImageRecordIter",
           "ImageDetRecordIter", "DetRecordIter", "MNISTIter",
           "CSVIter", "LibSVMIter"]

_RECORDS_WAIT = ("the record iterators wait with the native record reader "
                 "(ROADMAP Queue A item 9)")


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """A named input: shape, dtype and layout."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: data and label arrays, pad, index, bucket key."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol of the data loaders."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        return self.next()

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """``data`` as sorted ``(name, NDArray)`` pairs."""
    if data is None:
        data = []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = {}
    for k, v in data.items():
        out[k] = v if isinstance(v, NDArray) else array(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Batches over in-memory arrays, with shuffle and the last batch
    padded (by wrapping to the start), discarded or rolled over. The
    shuffle is the JAX package's numpy shuffle: ``RandomState(shuffle_seed
    or None)`` at construction, the global ``numpy.random.shuffle`` on each
    reset, so that one seed gives the same batches in both packages."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 shuffle_seed=0,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = onp.arange(self.num_data)
        if shuffle:
            rng = onp.random.RandomState(shuffle_seed or None)
            rng.shuffle(self.idx)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrs):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[self.cursor:end]
        else:
            # pad by wrapping from the start, cycling if the batch is
            # larger than the dataset (idx[:pad] alone under-fills then,
            # emitting a short batch whose pad exceeds its length)
            pad = end - self.num_data
            sel = onp.concatenate([self.idx[self.cursor:],
                                   onp.resize(self.idx, pad)])
        # the numpy order gathered where the arrays are: on the card, no
        # copy of the dataset to the host and none of the batch back
        sel = torch.from_numpy(onp.ascontiguousarray(sel))
        return [_wrap(v._data.index_select(0, sel.to(v._data.device)))
                for _, v in arrs]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """An iterator clipped (or looped) to ``size`` batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _PrefetchError:
    """Queue sentinel carrying a worker-thread exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchingIter(DataIter):
    """Batches of one or more iterators, read ahead by a background
    thread; an exception in the thread is raised by ``next``."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.prefetch_depth = prefetch_depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    def _start(self):
        # the worker binds ITS epoch's queue/stop-event, not self._…:
        # if reset() times out joining a worker that is stuck in a slow
        # it.next(), the straggler's final put() lands in the orphaned
        # old queue instead of poisoning the new epoch with a stale batch
        q, stop = self._queue, self._stop
        # the worker makes its batches in the creator's `with ctx:` scope
        stack = getattr(Context._default_ctx, "stack", None)
        scope = stack[-1] if stack else contextlib.nullcontext()

        def worker():
            with scope:
                self._fill(q, stop)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _fill(self, q, stop):
        while not stop.is_set():
            try:
                batches = [it.next() for it in self.iters]
            except StopIteration:
                q.put(None)
                return
            except BaseException as e:  # noqa: BLE001
                # a dying worker must not strand the consumer: ship
                # the exception through the queue (next() re-raises
                # it) instead of exiting silently and leaving
                # queue.get() blocked forever
                q.put(_PrefetchError(e))
                return
            q.put(batches)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        # drain-and-join until the worker is dead (bounded): each drain
        # unblocks a worker stuck in queue.put, letting it see the stop
        # event. A worker stuck >5 s inside it.next() is abandoned as a
        # straggler — it holds the OLD queue/stop bindings (see _start)
        # so it cannot poison the new epoch's queue, but it may still
        # race it.reset() on the shared underlying iterators; nothing
        # short of an unbounded wait can close that, so we bound.
        self._stop.set()
        deadline = time.monotonic() + 5.0
        while True:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            if self._thread is None or not self._thread.is_alive() \
                    or time.monotonic() > deadline:
                break
            self._thread.join(timeout=0.1)
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.prefetch_depth)
        self._start()

    def next(self):
        batches = self._queue.get()
        if batches is None:
            # re-enqueue the one-shot end marker: the worker is dead, so
            # a second next() after exhaustion must raise StopIteration
            # again instead of blocking forever on an empty queue
            self._queue.put(None)
            raise StopIteration
        if isinstance(batches, _PrefetchError):
            # keep the sentinel available so every subsequent next()
            # fails the same way instead of blocking on an empty queue
            self._queue.put(batches)
            raise batches.exc
        if len(batches) == 1:
            return batches[0]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([b.label for b in batches], []),
            pad=batches[0].pad, index=batches[0].index)

    def iter_next(self):
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False


def _waiting(name):
    def it(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: "
                                  f"{_RECORDS_WAIT}")
    it.__name__ = name
    it.__doc__ = f"Not ported yet: {_RECORDS_WAIT}."
    return it


MXDataIter = _waiting("MXDataIter")
ImageRecordIter = _waiting("ImageRecordIter")
ImageDetRecordIter = _waiting("ImageDetRecordIter")
DetRecordIter = ImageDetRecordIter
LibSVMIter = _waiting("LibSVMIter")


def MNISTIter(image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
              batch_size=128, shuffle=True, flat=False, seed=0,
              silent=False, data_shape=(1, 28, 28), **kwargs):
    """MNIST's idx-ubyte files (``.gz`` too) as an ``NDArrayIter`` of
    images scaled to [0, 1]; the last partial batch is discarded."""
    import gzip
    import struct

    def read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

    imgs = read_idx(image).astype(onp.float32) / 255.0
    labels = read_idx(label).astype(onp.float32)
    if flat:
        imgs = imgs.reshape(imgs.shape[0], -1)
    else:
        imgs = imgs.reshape((-1,) + tuple(data_shape))
    return NDArrayIter(imgs, labels, batch_size=batch_size, shuffle=shuffle,
                       last_batch_handle="discard")


def CSVIter(data_csv, data_shape, label_csv=None, label_shape=(1,),
            batch_size=128, round_batch=True, **kwargs):
    """Rows of a CSV file (and of a label file) as an ``NDArrayIter``."""
    data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32)
    data = data.reshape((-1,) + tuple(data_shape))
    label = None
    if label_csv:
        label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32)
        label = label.reshape((-1,) + tuple(label_shape))
    return NDArrayIter(data, label, batch_size=batch_size)
