"""Autograd scopes and backward over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py``'s scopes (``record``, ``pause``,
``train_mode``, ``predict_mode``) and ``backward``. There is no tape of
its own: torch records the graph. The thread-local flags say what MXNet's
say: ``is_recording()`` (inside ``record``, where torch records gradients;
``pause`` turns torch's recording off) and ``is_training()``, which layers
such as ``Dropout`` read to decide whether they act.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_rec: bool) -> bool:
    """Set the recording flag; returns the previous one."""
    prev, _STATE.recording = _STATE.recording, bool(is_rec)
    return prev


def set_training(train: bool) -> bool:
    """Set the training flag; returns the previous one."""
    prev, _STATE.training = _STATE.training, bool(train)
    return prev


class _Scope:
    """Sets the flags on entry and restores them on exit; a scope that
    sets recording also turns torch's gradient recording on or off."""

    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training
        self._prev_rec = self._prev_train = None
        self._grad = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
            self._grad = torch.set_grad_enabled(self._rec)
            self._grad.__enter__()
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._grad.__exit__(*exc)
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True) -> _Scope:
    """Record for gradients; layers act in training mode unless
    ``train_mode=False``."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Stop recording inside a ``record`` scope."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _reached_leaves(heads: Sequence[torch.Tensor]) -> list:
    """The leaves whose gradient a backward from ``heads`` deposits: the
    variables of the ``AccumulateGrad`` nodes of the heads' graph (and any
    head that is itself a leaf)."""
    leaves, seen = [], set()
    stack = []
    for h in heads:
        if h.grad_fn is not None:
            stack.append(h.grad_fn)
        elif h.requires_grad:
            leaves.append(h)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return leaves


def backward(heads: Tensors, head_grads: Optional[Tensors] = None,
             retain_graph: bool = False) -> None:
    """Gradients of ``heads`` into the ``.grad`` of the leaves they depend
    on. A head without a head gradient gets ones, as in MXNet, so a
    per-sample loss sums over its samples.

    Each leaf the backward reaches is deposited into by its ``grad_req``,
    as in the JAX package: under the default ``"write"`` the new gradient
    replaces what ``.grad`` held; a leaf whose ``grad_req`` attribute is
    ``"add"`` accumulates. A leaf the backward does not reach keeps its
    ``.grad``."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None or isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads] * len(heads) if head_grads is None \
            else [head_grads]
    if len(head_grads) != len(heads):
        raise ValueError(f"{len(heads)} heads but {len(head_grads)} head "
                         "gradients")
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    for leaf in _reached_leaves(heads):
        if leaf.grad is not None and \
                getattr(leaf, "grad_req", "write") != "add":
            leaf.grad = None
    torch.autograd.backward(list(heads), grads, retain_graph=retain_graph)
