"""Execution-engine facade.

Counterpart of ``mxnet_tpu/engine.py``: the reference's dependency engine
exists to overlap asynchronous op execution with Python; on CUDA the
stream order of PyTorch's launches gives the same guarantees. This module
keeps the control surface: engine-type selection (``NaiveEngine`` =
synchronous, for debugging), the bulking knob (advisory, as in the
reference), and ``wait_for_all`` (``torch.cuda.synchronize``). The op
dispatch (``ops.registry.call_op``) calls :func:`block_if_sync` after
every eager op, so that under ``MXNET_EAGER_SYNC`` or ``NaiveEngine`` a
device error surfaces at the op that raised it. ``eager_sync``'s
profiler condition (the ``imperative`` domain) waits for the profiler,
ROADMAP Queue A item 8.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import config

__all__ = ["set_bulk_size", "bulk", "is_sync", "eager_sync",
           "block_if_sync", "wait_for_all", "set_engine_type"]


class _State(threading.local):
    engine_type = None  # set_engine_type's choice for this thread


_state = _State()


def set_engine_type(name: str):
    """``"NaiveEngine"`` makes dispatch synchronous (the reference's
    ``MXNET_ENGINE_TYPE``); any other name restores the default."""
    _state.engine_type = name


_FLAGS_CACHE = [-1, False, False]  # [config generation, naive, eager]


def _flags():
    """``(MXNET_ENGINE_TYPE == NaiveEngine, MXNET_EAGER_SYNC)``, read once
    per :func:`config.generation` (the op dispatch asks after every op):
    an environment change is seen at the next ``set_flag``/``unset_flag``,
    as in the JAX package."""
    gen = config.generation()
    if _FLAGS_CACHE[0] != gen:
        _FLAGS_CACHE[1] = config.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
        _FLAGS_CACHE[2] = config.get("MXNET_EAGER_SYNC")
        _FLAGS_CACHE[0] = gen
    return _FLAGS_CACHE[1], _FLAGS_CACHE[2]


def is_sync() -> bool:
    """Synchronous dispatch: ``NaiveEngine``, set here or by
    ``MXNET_ENGINE_TYPE``."""
    et = _state.engine_type
    if et is None:
        return _flags()[0]
    return et == "NaiveEngine"


def eager_sync() -> bool:
    """Should the eager path block after every op? Off by default (CUDA
    launches queue asynchronously); on under ``MXNET_EAGER_SYNC`` or
    :func:`is_sync`."""
    return is_sync() or _flags()[1]


def block_if_sync() -> bool:
    """After an eager op: wait for the current CUDA device when
    :func:`eager_sync` asks for it (not while a CUDA graph is being
    captured, where a wait is illegal and nothing runs). Whether it
    waited."""
    if not eager_sync() or not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return False
    torch.cuda.synchronize()
    return True


_BULK_SIZE = [15]  # the reference's MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN


def set_bulk_size(size: int) -> int:
    """The reference's ``Engine::set_bulk_size``; advisory here (PyTorch
    launches op by op). Returns the previous size."""
    prev, _BULK_SIZE[0] = _BULK_SIZE[0], size
    return prev


@contextlib.contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def wait_for_all():
    """The reference's ``Engine::WaitForAll``: every queued launch on
    every stream of the current CUDA device done (nothing to wait for
    without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
