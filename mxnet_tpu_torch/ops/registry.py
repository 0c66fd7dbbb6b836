"""Op registry: one registration mechanism for the op corpus, and the
generated ``nd.<op>`` functions.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op is a plain function
on ``torch.Tensor``s: its leading parameters without defaults are the
tensor inputs, its keyword parameters with defaults the op's parameters.
The registry keeps name -> :class:`OpInfo` for the ``mx.nd`` namespace,
aliases and docs; torch records the gradient, so there is no tape and no
shape inference of its own.

:func:`make_nd_function` builds ``nd.<name>``. The generated function

1. unwraps its NDArray (or tensor) arguments; other positional arguments
   fill the op's parameters in order;
2. passes the device's ``torch.Generator`` as ``_generator`` to a
   ``needs_rng`` op and ``autograd.is_training()`` as ``_training`` to a
   ``needs_train`` op;
3. calls the function: inside ``autograd.record()`` torch records it,
   outside under ``torch.no_grad()``, as the reference records nothing
   there (so an update written by hand outside ``record`` may write into
   a parameter in place); a non-differentiable op never records;
4. wraps the outputs as NDArrays (hiding an op's invisible outputs);
5. with ``out=`` writes the result into the given NDArray(s) in place;
   an op that updates state (the optimizer updates, :attr:`OpInfo.mutates`)
   then also writes its new state into the state inputs, as MXNet's
   mutable inputs do. Without ``out=`` it returns every output and
   changes nothing, as the JAX package does.

Two hooks sit in front of the call. A sparse input (an array whose
``stype`` is not ``"default"``), or ``sparse_grad=True``, first asks
:func:`mxnet_tpu_torch.ndarray.sparse_ops.maybe_sparse_dispatch` for the
op's sparse implementation (the reference's FComputeEx choice); where it
has none, the op runs densely on the inputs' dense views and
:func:`~mxnet_tpu_torch.ndarray.sparse.log_storage_fallback` warns once
for the op. The amp cast hook asks :mod:`mxnet_tpu_torch.amp` for a cast
plan; until ``amp.init`` exists (the deferred half of ROADMAP Queue A
item 1) there is none and the hook does nothing.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional

import torch

from .. import engine
from ..base import MXNetError

__all__ = ["register_op", "get_op", "has_op", "list_ops", "OpInfo",
           "make_nd_function", "parse_bool_param", "stub_op"]


def parse_bool_param(v) -> bool:
    """An op parameter that may arrive as a string ("1"/"true"/"on",
    "0"/"false"/"off") as a bool; another string raises."""
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off", ""):
            return False
        raise MXNetError(
            f"invalid boolean parameter value {v!r}: expected one of "
            f"1/true/yes/on or 0/false/no/off")
    return bool(v)


class OpInfo:
    """A registered op: its function and what the nd layer needs to call
    it (output count, differentiability, the generator and training
    flags, visible outputs, and the state it updates under ``out=``)."""

    __slots__ = ("name", "fn", "n_out", "differentiable", "arg_names",
                 "defaults", "needs_rng", "needs_train", "input_names",
                 "aux_updates", "visible_outputs", "mutates", "param_names",
                 "stub")

    def __init__(self, name, fn, n_out, differentiable, needs_rng=False,
                 needs_train=False, input_names=None, aux_updates=None,
                 visible_outputs=None, mutates=None, stub=False):
        self.name = name
        self.fn = fn
        self.n_out = n_out
        self.differentiable = differentiable
        self.needs_rng = needs_rng
        self.needs_train = needs_train
        self.input_names = input_names
        self.aux_updates = aux_updates or {}
        self.visible_outputs = visible_outputs
        # output index -> input index written in place under out= (a
        # dict, or a callable of the call's params giving one)
        self.mutates = mutates or {}
        self.stub = stub
        self.arg_names: List[str] = []
        self.defaults: Dict[str, object] = {}
        for pname, p in inspect.signature(fn).parameters.items():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                self.arg_names.append("*")
                continue
            self.arg_names.append(pname)
            if p.default is not p.empty:
                self.defaults[pname] = p.default
        # the parameters a positional non-tensor argument may fill
        self.param_names = [n for n in self.arg_names if n in self.defaults
                            and not n.startswith("_")]

    def inputs_for(self, params) -> List[str]:
        """The op's declared input names for a call with ``params``
        (``input_names`` may be a callable of the params, as
        ``visible_outputs`` may)."""
        names = self.input_names
        if callable(names):
            names = names(params)
        return list(names or [])


_OPS: Dict[str, OpInfo] = {}


def register_op(name: str, n_out: int = 1, differentiable: bool = True,
                aliases: Optional[List[str]] = None, needs_rng: bool = False,
                needs_train: bool = False, input_names=None,
                aux_updates=None, visible_outputs=None, mutates=None,
                doc: Optional[str] = None, stub: bool = False):
    """Register a function on tensors under an MXNet op name (and its
    ``aliases``). ``n_out=-1``: the count comes from the call's
    ``num_outputs`` or from the function's result. ``doc`` documents a
    lambda or a loop-made function that has no docstring of its own."""

    def deco(fn):
        if doc and not (fn.__doc__ or "").strip():
            fn.__doc__ = doc
        info = OpInfo(name, fn, n_out, differentiable, needs_rng,
                      needs_train, input_names, aux_updates,
                      visible_outputs, mutates, stub)
        _OPS[name] = info
        for a in aliases or []:
            _OPS[a] = info
        return fn

    return deco


def stub_op(name: str, waits: str, aliases=None) -> None:
    """Register ``name`` as an op that raises ``NotImplementedError``
    naming where it waits, so that a missing op never surfaces as an
    ``AttributeError``."""

    def fn(*args, **kwargs):
        raise NotImplementedError(f"operator {name!r} is not ported yet: "
                                  f"{waits}")

    fn.__doc__ = f"Not ported yet: {waits}."
    register_op(name, aliases=aliases, differentiable=False, stub=True)(fn)


def get_op(name: str) -> OpInfo:
    if name not in _OPS:
        raise MXNetError(f"operator '{name}' is not registered")
    return _OPS[name]


def has_op(name: str) -> bool:
    return name in _OPS


def list_ops() -> List[str]:
    return sorted(_OPS)


def _sparse_hook(name, inputs, params):
    """The sparse implementation's result for a sparse input (or
    ``sparse_grad=True``), recorded inside ``autograd.record()`` only; else
    ``NotImplemented``, with the storage-fallback warning where an input
    is sparse."""
    sparse_in = any(getattr(a, "stype", "default") != "default"
                    for a in inputs)
    if not sparse_in and not parse_bool_param(params.get("sparse_grad",
                                                         False)):
        return NotImplemented
    from .. import autograd
    from ..ndarray.sparse import log_storage_fallback
    from ..ndarray.sparse_ops import maybe_sparse_dispatch
    res = call_op(maybe_sparse_dispatch, autograd.is_recording(), name,
                  inputs, params)
    if res is NotImplemented and sparse_in:
        log_storage_fallback(name)
    return res


def _amp_hook(name, fn):
    """``fn`` with the amp cast plan of ``name`` applied to its inputs,
    or ``fn`` itself when amp has none (always, until ``amp.init``)."""
    from .. import amp
    plan = amp.cast_plan(name) if amp.is_active() else None
    if plan is None:
        return fn

    def cast_fn(*arrays, **kw):
        return fn(*plan(list(arrays)), **kw)

    return cast_fn


_set_grad = torch._C._set_grad_enabled
_block_if_sync = engine.block_if_sync


def call_op(fn, recorded: bool, *args, **kwargs):
    """``fn(*args, **kwargs)`` with torch recording exactly when
    ``recorded`` (an op inside ``autograd.record()``); then, under
    ``MXNET_EAGER_SYNC`` or ``NaiveEngine``, a wait for the device
    (``engine.block_if_sync``)."""
    if recorded or not torch.is_grad_enabled():
        out = fn(*args, **kwargs)
    else:
        _set_grad(False)
        try:
            out = fn(*args, **kwargs)
        finally:
            _set_grad(True)
    _block_if_sync()
    return out


def add_call_params(info: OpInfo, params: dict, training: bool,
                    device) -> dict:
    """``params`` with what an op takes besides its own parameters: the
    training flag where it ``needs_train`` (unless given) and ``device``'s
    generator where it ``needs_rng`` (none on the meta device, where only
    shapes are computed). Shared by ``nd`` and the graph executor."""
    if info.needs_train and "_training" not in params:
        params["_training"] = training
    if info.needs_rng:
        from ..random import generator
        params["_generator"] = None if device.type == "meta" \
            else generator(device)
    return params


def make_nd_function(name: str) -> Callable:
    """The user-facing ``nd.<name>``: NDArrays in and out (see the module
    docstring)."""
    info = _OPS[name]
    order = {n: i for i, n in enumerate(info.arg_names)}

    def nd_fn(*args, out=None, name=None, **kwargs):
        from .. import autograd
        from ..context import as_device
        from ..ndarray.ndarray import NDArray, _unwrap, _wrap_out

        inputs = []
        params = {}
        pi = 0
        pnames = info.param_names
        for a in args:
            if isinstance(a, (NDArray, torch.Tensor)):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], (NDArray, torch.Tensor)):
                inputs.extend(a)
            else:
                while pi < len(pnames) and pnames[pi] in kwargs:
                    pi += 1
                if pi >= len(pnames):
                    raise MXNetError(f"{info.name}: too many positional "
                                     f"arguments")
                params[pnames[pi]] = a
                pi += 1
        named = []
        for k, v in kwargs.items():
            if isinstance(v, (NDArray, torch.Tensor)):
                named.append((order.get(k, len(order)), v))
            else:
                params[k] = v
        if named:
            named.sort(key=lambda kv: kv[0])
            inputs.extend(v for _, v in named)
        res = _sparse_hook(info.name, inputs, params)
        if res is not NotImplemented:
            if out is not None:
                out._assign(res._data, autograd.is_recording())
                return out
            return res
        tensors = [_unwrap(a) for a in inputs]
        fn = _amp_hook(info.name, info.fn)
        dev = None
        if info.needs_rng:
            dev = tensors[0].device if tensors \
                else as_device(params.get("ctx"))
        add_call_params(info, params, autograd.is_training(), dev)
        recorded = info.differentiable and autograd.is_recording()
        res = call_op(fn, recorded, *tensors, **params)
        vis = info.visible_outputs
        if callable(vis):
            vis = vis(params)
        if vis is not None and not info.aux_updates \
                and isinstance(res, (tuple, list)) and vis < len(res):
            res = res[0] if vis == 1 else tuple(res[:vis])
        if out is not None:
            return _write_out(info, res, out, inputs, params, recorded)
        return _wrap_out(res)

    nd_fn.__name__ = name
    nd_fn.__qualname__ = name
    nd_fn.__doc__ = info.fn.__doc__
    nd_fn._mx_registry_dispatch = True
    return nd_fn


def _write_out(info, res, out, inputs, params, recorded):
    """Write ``res`` into ``out`` (an NDArray, or a list of them for the
    leading outputs) and, for an op with :attr:`OpInfo.mutates`, the new
    state into the state inputs; returns ``out``."""
    from ..ndarray.ndarray import NDArray
    outs = list(res) if isinstance(res, (tuple, list)) else [res]
    targets = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(targets) > len(outs):
        raise MXNetError(f"{info.name}: {len(targets)} out arrays for "
                         f"{len(outs)} outputs")
    for dst, src in zip(targets, outs):
        dst._assign(src, recorded)
    mutates = info.mutates(params) if callable(info.mutates) \
        else info.mutates
    for o_idx, i_idx in mutates.items():
        if o_idx >= len(targets) and o_idx < len(outs) \
                and isinstance(inputs[i_idx], NDArray):
            inputs[i_idx]._assign(outs[o_idx], recorded)
    return out
