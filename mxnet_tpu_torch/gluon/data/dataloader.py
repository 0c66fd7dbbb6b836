"""The DataLoader: batches of a dataset, loaded in the calling process,
in a pool of threads, or in worker processes.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``. With
``num_workers=0`` each batch is loaded and batchified in the caller.
With ``thread_pool=True`` (the JAX package's in-process pool) a
``concurrent.futures.ThreadPoolExecutor`` of ``num_workers`` threads
loads and batchifies whole batches, ``prefetch`` of them in flight, and
yields them in the sampler's order: each thread reads its samples under
``with mx.cpu():`` (decoding, transforms and the stacking run on the
host, outside the interpreter lock where the work is native), and the
caller moves each batch to its own context. With worker processes the
port uses torch's own (``torch.utils.data.DataLoader`` over this loader's
batch sampler): each worker reads its samples and batchifies them into
CPU tensors (:func:`default_mp_batchify_fn`), which come back through
shared memory, pinned where ``pin_memory`` and CUDA allow, with
``prefetch`` batches in flight. A worker never touches CUDA: it runs
under a ``with mx.cpu():`` context, and an NDArray a dataset returns
there is read as numpy. In every mode the caller receives NDArrays on
the current context, where the JAX package puts its batches
(``nd.array``'s default).
"""
from __future__ import annotations

import collections
import concurrent.futures

import numpy as onp
import torch

from ...context import Context, as_device, cpu
from ...ndarray.ndarray import NDArray, _wrap, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack a list of samples into NDArrays on the current context (a
    list of them where samples are tuples)."""
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    if isinstance(data[0], NDArray):
        return _wrap(torch.stack([d._data for d in data]))
    if isinstance(data[0], torch.Tensor):
        return _wrap(torch.stack(data).to(as_device()))
    return array(onp.asarray(data))


def default_mp_batchify_fn(data):
    """A worker's batchify: CPU tensors (a list of them where samples are
    tuples), no NDArray and no device."""
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(list(i)) for i in zip(*data)]
    if isinstance(data[0], NDArray):
        data = [d.asnumpy() for d in data]
    if isinstance(data[0], torch.Tensor):
        return torch.stack(data)
    return torch.from_numpy(onp.ascontiguousarray(onp.asarray(data)))


def _to_nd(batch, device):
    """A worker's batch (tensors or NDArrays) as NDArrays on ``device``."""
    if isinstance(batch, (list, tuple)):
        return [_to_nd(b, device) for b in batch]
    if isinstance(batch, NDArray):
        batch = batch._data
    if isinstance(batch, torch.Tensor):
        return _wrap(batch.to(device, non_blocking=batch.is_pinned()))
    return batch


def _worker_init(worker_id):
    # the worker's nd defaults to the CPU: nothing there reaches CUDA
    Context("cpu").__enter__()


class DataLoader:
    """Batches of ``dataset``: from ``batch_sampler``, or from a
    ``BatchSampler`` of ``batch_size`` over ``sampler`` (a
    ``RandomSampler`` where ``shuffle``, else sequential) with
    ``last_batch`` (``"keep"``, ``"discard"`` or ``"rollover"``), loaded
    in the caller, in ``num_workers`` threads (``thread_pool=True``) or in
    ``num_workers`` processes."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._loader = self._pool = None
        prefetch = max(0, int(prefetch) if prefetch is not None
                       else 2 * self._num_workers)
        if self._num_workers > 0 and thread_pool:
            self._batchify_fn = batchify_fn or default_batchify_fn
            self._prefetch = max(1, prefetch)
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._num_workers)
        elif self._num_workers > 0:
            self._batchify_fn = batchify_fn or default_mp_batchify_fn
            self._loader = torch.utils.data.DataLoader(
                dataset, batch_sampler=batch_sampler,
                num_workers=self._num_workers,
                collate_fn=self._batchify_fn,
                pin_memory=pin_memory and torch.cuda.is_available(),
                timeout=timeout, worker_init_fn=_worker_init,
                prefetch_factor=max(1, -(-prefetch // self._num_workers)))
        else:
            self._batchify_fn = batchify_fn or default_batchify_fn

    def _load_on_host(self, indices):
        with cpu():
            return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._loader is not None:
            device = as_device()
            for batch in self._loader:
                yield _to_nd(batch, device)
            return
        if self._pool is not None:
            yield from self._thread_iter()
            return
        for batch_idx in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in batch_idx])

    def _thread_iter(self):
        """The thread pool's batches in the sampler's order, ``prefetch``
        of them loading at a time."""
        device = as_device()
        indices = iter(self._batch_sampler)
        pending = collections.deque()
        try:
            for batch_idx in indices:
                pending.append(self._pool.submit(self._load_on_host,
                                                 batch_idx))
                if len(pending) >= self._prefetch:
                    yield _to_nd(pending.popleft().result(self._timeout),
                                 device)
            while pending:
                yield _to_nd(pending.popleft().result(self._timeout),
                             device)
        finally:
            for fut in pending:  # an abandoned epoch: drop its batches
                fut.cancel()

    def __len__(self):
        return len(self._batch_sampler)
