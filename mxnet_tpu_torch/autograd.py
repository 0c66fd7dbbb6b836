"""Autograd scopes, backward and grad over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py``: the scopes (``record``,
``pause``, ``train_mode``, ``predict_mode``), ``backward``, ``grad``,
``mark_variables`` and ``Function``. There is no tape of its own: torch
records the graph. The thread-local flags say what MXNet's say:
``is_recording()`` (inside ``record``, where torch records gradients;
``pause`` turns torch's recording off) and ``is_training()``, which layers
such as ``Dropout`` read to decide whether they act. Heads, head
gradients and variables may be tensors or NDArrays; ``grad`` returns
NDArrays. ``get_symbol`` waits with the symbolic stack (ROADMAP Queue A
item 5).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function", "get_symbol"]


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


def _tensor(a):
    """The tensor of an NDArray (or the tensor itself)."""
    return getattr(a, "_data", a)


def _tensors(xs) -> list:
    if xs is None:
        return None
    if isinstance(xs, (list, tuple)):
        return [None if x is None else _tensor(x) for x in xs]
    return [_tensor(xs)]


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


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` into the ``.grad`` of the leaves they depend
    on. A head without a head gradient gets ones, as in MXNet, so a
    per-sample loss sums over its samples.

    Each leaf the backward reaches is deposited into by its ``grad_req``,
    as in the JAX package: under the default ``"write"`` the new gradient
    replaces what ``.grad`` held; a leaf whose ``grad_req`` attribute is
    ``"add"`` accumulates. A leaf the backward does not reach keeps its
    ``.grad``; a head that depends on no variable gives nothing. The
    gradient buffer of an NDArray variable
    (``attach_grad``, :func:`mark_variables`) keeps its identity: it is
    zeroed and written in place, so a reference to ``x.grad`` taken before
    the backward sees the new gradient, as in MXNet.

    A sparse slot (``attach_grad(stype="row_sparse")``) and a sparse leaf
    (an attached ``RowSparseNDArray``) take the JAX package's deposit
    rules (``mxnet_tpu/autograd.py:315-373``), in :func:`_deposit_sparse`."""
    heads = _tensors(heads)
    head_grads = [None] * len(heads) if head_grads is None \
        else _tensors(head_grads)
    if len(head_grads) != len(heads):
        raise ValueError(f"{len(heads)} heads but {len(head_grads)} head "
                         "gradients")
    grads = [torch.ones_like(h) if g is None else g.to(h.dtype)
             for h, g in zip(heads, head_grads)]
    # a head that depends on no variable (a BlockGrad output, say) has no
    # gradient to give, as in the reference
    keep = [i for i, h in enumerate(heads) if h.requires_grad]
    if not keep:
        return
    heads, grads = [heads[i] for i in keep], [grads[i] for i in keep]
    leaves = _reached_leaves(heads)
    sparse = []
    for leaf in leaves:
        if getattr(leaf, "_mx_grad_stype", None) is not None:
            # torch leaves a sparse COO gradient here (the sparse ops') or
            # a dense one; the deposit below reads it
            leaf.grad = None
            sparse.append(leaf)
        elif leaf.grad is not None and \
                getattr(leaf, "grad_req", "write") != "add":
            if getattr(leaf, "_mx_keep_grad", False):
                leaf.grad.zero_()
            else:
                leaf.grad = None
    torch.autograd.backward(list(heads), grads, retain_graph=retain_graph)
    for leaf in sparse:
        _deposit_sparse(leaf)


def _deposit_sparse(leaf: torch.Tensor) -> None:
    """Deposit the gradient torch left on a sparse slot or leaf:

    - a sparse cotangent into a sparse slot stays ``row_sparse`` (sorted
      unique rows), replacing the slot under ``write`` and merged with it
      under ``add``;
    - a dense cotangent into a sparse slot makes the gradient dense (plus
      the old sparse one under ``add``), and the slot dense from then on;
    - a leaf stored sparse gets a values-shaped gradient, paired with its
      own indices.

    (A sparse cotangent into a dense slot was densified by torch, which
    adds it into the dense ``.grad``.)"""
    from .ndarray.sparse import RowSparseNDArray
    from .ndarray.sparse_ops import SparseCotangent
    g, leaf.grad = leaf.grad, None
    if g is None:
        return
    add = getattr(leaf, "grad_req", "write") == "add"
    prev = leaf._mx_sparse_grad
    if leaf._mx_grad_stype == "payload":
        owner = leaf._mx_owner()
        cot = SparseCotangent(g, owner._aux["indices"], owner.shape)
    elif g.is_sparse:
        cot = SparseCotangent.from_coo(g)
    else:
        if add:
            g = g + prev._data.to(g.dtype)
        leaf.grad = g
        leaf._mx_grad_stype = leaf._mx_sparse_grad = None
        leaf._mx_keep_grad = True
        return
    if add and prev._aux["values"].shape[0]:
        cot = SparseCotangent(prev._aux["values"],
                              prev._aux["indices"], prev.shape) + cot
    elif leaf._mx_grad_stype == "payload":
        leaf._mx_sparse_grad = RowSparseNDArray(g, cot.indices, cot.shape)
        return
    leaf._mx_sparse_grad = cot.to_rowsparse()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables``, as
    NDArrays, without touching any ``.grad`` (zeros for a variable the
    heads do not depend on). With ``create_graph`` (inside ``record``)
    the gradients are themselves recorded, so they can be differentiated
    again."""
    from .base import MXNetError
    from .ndarray.ndarray import _wrap
    if create_graph and not is_recording():
        raise MXNetError("create_graph=True requires an active "
                         "autograd.record() scope")
    heads = _tensors(heads)
    variables = _tensors(variables)
    head_grads = [None] * len(heads) if head_grads is None \
        else _tensors(head_grads)
    outs = [torch.ones_like(h) if g is None else g.to(h.dtype)
            for h, g in zip(heads, head_grads)]
    res = torch.autograd.grad(heads, variables, outs,
                              retain_graph=bool(retain_graph) or create_graph,
                              create_graph=create_graph, allow_unused=True)
    # a sparse gradient is densified, as the JAX package's dense scratch
    # slots do
    return [_wrap(torch.zeros_like(v) if g is None else
                  g.to_dense() if g.is_sparse else g)
            for v, g in zip(variables, res)]


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each variable a leaf whose gradient is written into the
    matching array of ``gradients`` (in place, by its ``grad_req``)."""
    variables, gradients = _tensors(variables), _tensors(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req == "null":
            var.requires_grad_(False)
            var.grad = None
            continue
        var.requires_grad_(True)
        var.grad = g
        var.grad_req = req
        var._mx_keep_grad = True


def get_symbol(x):
    raise NotImplementedError(
        "autograd.get_symbol: the symbolic stack is not ported yet "
        "(ROADMAP Queue A item 5)")


class _FunctionBridge(torch.autograd.Function):
    """Runs a :class:`Function`'s forward and backward on NDArrays inside
    one torch autograd node."""

    @staticmethod
    def forward(ctx, fobj, *tensors):
        from .ndarray.ndarray import _wrap
        ctx.fobj = fobj
        with pause():
            outs = fobj.forward(*[_wrap(t) for t in tensors])
        fobj._single = not isinstance(outs, (tuple, list))
        outs = [outs] if fobj._single else list(outs)
        ins = {id(t) for t in tensors}
        # an output that is an input is given its own tensor, so the node
        # does not alias an input
        return tuple(_tensor(o).clone() if id(_tensor(o)) in ins
                     else _tensor(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import _wrap
        with pause():
            in_grads = ctx.fobj.backward(*[_wrap(g) for g in grads])
        if not isinstance(in_grads, (tuple, list)):
            in_grads = (in_grads,)
        return (None,) + tuple(None if g is None else _tensor(g)
                               for g in in_grads)


class Function:
    """A differentiable function with its own backward: subclass and
    define ``forward(self, *inputs)`` and ``backward(self,
    *output_grads)`` on NDArrays (both run with recording paused);
    ``save_for_backward`` keeps what the backward needs."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import _wrap
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = _FunctionBridge.apply(self, *[_tensor(i) for i in inputs])
        outs = [_wrap(o) for o in outs]
        return outs[0] if self._single else outs
