"""The DataLoader: batches of a dataset, loaded in the calling process
or in worker processes.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``. With
``num_workers=0`` each batch is loaded and batchified in the caller.
With worker processes the port uses torch's own
(``torch.utils.data.DataLoader`` over this loader's batch sampler): each
worker reads its samples and batchifies them into CPU tensors
(:func:`default_mp_batchify_fn`), which come back through shared memory,
pinned where ``pin_memory`` and CUDA allow, with ``prefetch`` batches in
flight. A worker never touches CUDA: it runs under a ``with mx.cpu():``
context, and an NDArray a dataset returns there is read as numpy. In
either mode the caller receives NDArrays on the current context, where
the JAX package puts its batches (``nd.array``'s default). The JAX
package's in-process thread pool (``thread_pool=True``) is not ported.
"""
from __future__ import annotations

import numpy as onp
import torch

from ...context import Context, as_device
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
    """A worker's batch as NDArrays on ``device``."""
    if isinstance(batch, (list, tuple)):
        return [_to_nd(b, device) for b in batch]
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
    ``last_batch`` (``"keep"``, ``"discard"`` or ``"rollover"``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 timeout=120):
        self._dataset = dataset
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
        self._loader = None
        if self._num_workers > 0:
            prefetch = max(0, int(prefetch) if prefetch is not None
                           else 2 * self._num_workers)
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

    def __iter__(self):
        if self._loader is not None:
            device = as_device()
            for batch in self._loader:
                yield _to_nd(batch, device)
            return
        for batch_idx in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in batch_idx])

    def __len__(self):
        return len(self._batch_sampler)
