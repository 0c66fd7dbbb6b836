"""Data iterators.

Counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (pad, discard, roll_over; the same shuffle
order as the JAX package for one seed), ``ResizeIter``,
``PrefetchingIter`` (a background thread), ``MNISTIter`` (idx files,
plain or gzipped), ``CSVIter`` and ``LibSVMIter``. ``NDArrayIter`` holds
its arrays on the context current at construction and gathers each batch
there; a Module moves each batch to its executors' device.

The record iterators: ``ImageRecordIter`` runs the native JPEG pipeline
(:class:`mxnet_tpu_torch.native.NativeImagePipeline`) where the file's
first record is a JPEG, else the Python pipeline
(:func:`mxnet_tpu_torch.image.ImageRecordIterPy`); the choice is made
once, reported as the iterator's ``backend`` (and ``codec`` or
``reason``), and a native failure (no codec to build with, a fault of the
decoder) raises. Its batches land on ``ctx``
(the context current when it was made). On the card a background thread stages
each batch into pinned memory and copies it on a side stream, so the
next batch's decode and copy overlap the caller's step.
``ImageDetRecordIter`` (``DetRecordIter``) decodes on the native pipeline
too. ``MXDataIter`` refuses, as the JAX package's does.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import namedtuple

import numpy as onp
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, _wrap, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MXDataIter", "ImageRecordIter",
           "ImageDetRecordIter", "DetRecordIter", "MNISTIter",
           "CSVIter", "LibSVMIter"]


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


class MXDataIter(DataIter):
    """The reference's iterators registered from C: refused, as in the JAX
    package, in favour of the named iterator classes."""

    def __init__(self, *a, **kw):
        raise MXNetError("MXDataIter: use the named iterator classes")


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


def LibSVMIter(data_libsvm, data_shape, batch_size=128, **kwargs):
    """Rows of a libsvm text file (``label idx:value ...``) as dense
    batches of an ``NDArrayIter``."""
    feats = []
    labels = []
    dim = int(onp.prod(data_shape))
    with open(data_libsvm) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            row = onp.zeros(dim, dtype=onp.float32)
            for tok in parts[1:]:
                i, v = tok.split(":")
                row[int(i)] = float(v)
            feats.append(row)
    data = onp.stack(feats).reshape((-1,) + tuple(data_shape))
    return NDArrayIter(data, onp.asarray(labels, onp.float32),
                       batch_size=batch_size)


# -- the record iterators -------------------------------------------------------

def _first_record_is_jpeg(path_imgrec) -> bool:
    """Whether the file's first record holds a JPEG (the native pipeline
    decodes JPEG only; PNG records take the Python pipeline)."""
    from ..recordio import MXRecordIO, unpack
    rec = MXRecordIO(path_imgrec, "r")
    try:
        first = rec.read()
    finally:
        rec.close()
    return first is not None and unpack(first)[1][:2] == b"\xff\xd8"


class _Staging:
    """Moves the native pipeline's batches to a CUDA device from a
    background thread: each batch is copied into one of ``slots`` pinned
    host buffers, then to a fresh device tensor on a side stream, with an
    event the consumer's stream waits on. A slot is written again only
    after the event of its last copy has completed, so a batch in flight
    is never overwritten."""

    DEPTH = 2  # batches copied ahead of the consumer

    def __init__(self, pipe, device, label_width):
        self._pipe = pipe
        self._device = device
        n = self.DEPTH + 1
        self._data = [torch.empty(pipe.batch_shape, dtype=torch.float32,
                                  pin_memory=True) for _ in range(n)]
        self._labels = [torch.empty((pipe.batch_size, label_width),
                                    dtype=torch.float32, pin_memory=True)
                        for _ in range(n)]
        self._done = [None] * n  # the event of each slot's last copy
        self._stream = torch.cuda.Stream(device)
        self._thread = None

    def start(self):
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.DEPTH)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            k = 0
            for data, labels, pad in self._pipe.batches():
                if self._done[k] is not None:
                    self._done[k].synchronize()
                self._data[k].copy_(torch.from_numpy(data))
                self._labels[k].copy_(torch.from_numpy(labels))
                with torch.cuda.stream(self._stream):
                    dev = self._data[k].to(self._device, non_blocking=True)
                    lab = self._labels[k].to(self._device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self._stream)
                self._done[k] = done
                k = (k + 1) % len(self._data)
                if not self._put((dev, lab, pad, done)):
                    return
            self._put(None)
        except BaseException as e:  # handed to the consumer, raised there
            self._put(e)

    def next(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        dev, lab, pad, done = item
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(done)
        # the tensors were made on the side stream: the allocator must
        # not hand their memory out again before the consumer is done
        dev.record_stream(consumer)
        lab.record_stream(consumer)
        return dev, lab, pad

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
        self._thread = None


class _NativeImageRecordIter(DataIter):
    """``ImageRecordIter`` over the native decode and augment pipeline."""

    backend = "native"

    def __init__(self, path_imgrec, data_shape, batch_size, label_width,
                 shuffle, mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1,
                 std_b=1, rand_crop=False, rand_mirror=False, resize=0,
                 seed=0, preprocess_threads=0, data_name="data",
                 label_name="softmax_label", **_ignored):
        super().__init__(batch_size)
        from ..native import NativeImagePipeline
        self.ctx = current_context()
        self._pipe = NativeImagePipeline(
            path_imgrec, batch_size, data_shape=data_shape,
            label_width=label_width, shuffle=shuffle, resize=resize,
            rand_crop=rand_crop, rand_mirror=rand_mirror,
            mean=(mean_r, mean_g, mean_b), std=(std_r, std_g, std_b),
            seed=seed, num_workers=preprocess_threads)
        self.codec = self._pipe.codec
        self.preprocess_threads = self._pipe.num_workers
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name, self.label_name = data_name, label_name
        device = self.ctx.torch_device
        self._staging = _Staging(self._pipe, device, label_width) \
            if device.type == "cuda" else None
        self._start()

    def _start(self):
        if self._staging is not None:
            self._staging.start()
        else:
            self._batches = self._pipe.batches()

    @property
    def decode_failures(self) -> int:
        return self._pipe.decode_failures

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self._staging is not None:
            self._staging.stop()
        else:
            self._batches.close()
        self._pipe.reset()
        self._start()

    def next(self):
        if self._staging is not None:
            data, labels, pad = self._staging.next()
        else:
            d, lab, pad = next(self._batches)
            data, labels = torch.from_numpy(d.copy()), \
                torch.from_numpy(lab.copy())
        if self.label_width == 1:
            labels = labels.reshape(-1)
        # the native pipeline wrap-pads the final partial batch and says
        # how many duplicates it holds (the reference's
        # last_batch_handle="pad")
        return DataBatch(data=[_wrap(data)], label=[_wrap(labels)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def close(self):
        if self._staging is not None:
            self._staging.stop()
        self._pipe.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224), batch_size=1,
                    label_width=1, shuffle=False, **kwargs):
    """Batches of a ``.rec`` file of images (ref: src/io/
    iter_image_recordio_2.cc ``ImageRecordIter``): resize the shorter side
    (``resize``), crop (``rand_crop``, else the centre), mirror
    (``rand_mirror``), normalise (``mean_r/g/b``, ``std_r/g/b``), on
    ``preprocess_threads`` threads, shuffled per ``seed``; the final batch
    wrap-padded; each batch on the context current when it was made. The
    native pipeline runs where the first record is a JPEG, else the Python
    pipeline; ``backend`` says which (``codec`` the native one's codec,
    ``reason`` why the Python one)."""
    current_context()  # no CUDA and no ``with mx.cpu():`` raises here
    if _first_record_is_jpeg(path_imgrec):
        return _NativeImageRecordIter(path_imgrec, data_shape, batch_size,
                                      label_width, shuffle, **kwargs)
    from ..image import ImageRecordIterPy, decoder
    it = ImageRecordIterPy(path_imgrec=path_imgrec, data_shape=data_shape,
                           batch_size=batch_size, label_width=label_width,
                           shuffle=shuffle, **kwargs)
    it.backend, it.codec = "python", decoder()
    it.reason = "the first record is not a JPEG"
    return it


class ImageDetRecordIter(DataIter):
    """Detection RecordIO iterator (ref: src/io/iter_image_det_recordio.cc
    and image_det_aug_default.cc, the SSD input tier).

    Records are packed with an array label ``[header_width,
    object_width, <extra header...>, (cls, xmin, ymin, xmax, ymax) * N]``
    in normalized coordinates. The native pipeline decodes and warps each
    image to ``data_shape`` (no crop, so the boxes stay valid); the
    horizontal flip moves the boxes with the pixels, drawn from a
    ``RandomState(seed)``. Data ``(B, C, H, W)``, labels ``(B, N, 5)``
    padded with ``label_pad_value``, on the context current when it was
    made.
    """

    backend = "native"

    def __init__(self, path_imgrec=None, data_shape=(3, 300, 300),
                 batch_size=1, shuffle=False, label_pad_width=0,
                 label_pad_value=-1.0, rand_mirror=False, resize=0,
                 mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1, std_b=1,
                 seed=0, preprocess_threads=0, **_ignored):
        super().__init__(batch_size)
        from .. import native
        from .. import recordio as rio
        self.ctx = current_context()
        if not _first_record_is_jpeg(path_imgrec):
            raise MXNetError(
                "ImageDetRecordIter requires JPEG-encoded records "
                "(the native decode path has no PNG support)")
        if label_pad_width <= 0:
            # scan the headers for the widest label (the reference's
            # first-pass estimate, iter_image_det_recordio.cc:332)
            reader = native.NativeRecordIO(path_imgrec)
            try:
                for i in range(len(reader)):
                    hdr, _ = rio.unpack(reader.read_idx(i))
                    width = 1 if isinstance(hdr.label, float) \
                        else len(hdr.label)
                    label_pad_width = max(label_pad_width, width)
            finally:
                reader.close()
        self.label_pad_width = label_pad_width
        self.label_pad_value = float(label_pad_value)
        self._rand_mirror = rand_mirror
        self._rng = onp.random.RandomState(seed)
        self.data_shape = tuple(data_shape)
        self._pipe = native.NativeImagePipeline(
            path_imgrec, batch_size, data_shape=data_shape,
            label_width=label_pad_width, shuffle=shuffle,
            rand_crop=False, rand_mirror=False, force_resize=True,
            mean=(mean_r, mean_g, mean_b), std=(std_r, std_g, std_b),
            seed=seed, num_workers=preprocess_threads,
            label_pad_value=self.label_pad_value)
        self.codec = self._pipe.codec
        self._iter = iter(self._pipe)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        n_obj = (self.label_pad_width - 2) // 5
        return [DataDesc("label", (self.batch_size, n_obj, 5))]

    def reset(self):
        self._pipe.reset()
        self._iter = iter(self._pipe)

    def next(self):
        data, labels = next(self._iter)
        B = data.shape[0]
        n_obj = (self.label_pad_width - 2) // 5
        boxes = onp.full((B, n_obj, 5), self.label_pad_value, "float32")
        for b in range(B):
            row = labels[b]
            hw = int(row[0]) if row[0] > 0 else 2
            ow = int(row[1]) if row[1] > 0 else 5
            body = row[hw:]
            k = 0
            for o in range(min(n_obj, len(body) // ow)):
                rec = body[o * ow:(o + 1) * ow]
                if rec[0] < 0:  # padding
                    continue
                boxes[b, k, :5] = rec[:5]
                k += 1
        if self._rand_mirror:
            flip = self._rng.rand(B) < 0.5
            for b in onp.where(flip)[0]:
                data[b] = data[b][:, :, ::-1]
                valid = boxes[b, :, 0] >= 0
                x1 = boxes[b, valid, 1].copy()
                x2 = boxes[b, valid, 3].copy()
                boxes[b, valid, 1] = 1.0 - x2
                boxes[b, valid, 3] = 1.0 - x1
        return DataBatch(data=[array(onp.ascontiguousarray(data),
                                     ctx=self.ctx)],
                         label=[array(boxes, ctx=self.ctx)],
                         pad=self._pipe.last_pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


DetRecordIter = ImageDetRecordIter
