"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``'s ``Block`` and
``HybridBlock``: the Gluon calls a training script makes on a model.
A layer's parameters are Gluon :class:`~mxnet_tpu_torch.gluon.parameter.
Parameter`s, each over one ``torch.nn.Parameter`` that the layer holds as
its attribute (``dense.weight``) and computes with:

- ``params``: the block's own :class:`ParameterDict` (``params.get``
  makes a parameter under the block's prefix); assigning a Parameter to
  an attribute registers its tensor, so a user block written for the JAX
  package (``self.w = self.params.get("w", shape=...)``, ``self.w.data()``
  or ``hybrid_forward(F, x, w)``) runs as written;
- ``collect_params(select=None)``: a :class:`ParameterDict` of every
  parameter under the JAX package's prefixed names
  (``hybridsequential0_dense0_weight``), in its order, ``select`` a
  regular expression matched on those names;
  ``_collect_params_with_prefix()`` the same parameters under structural
  names (``0.weight``), the keys of ``.params`` files;
- ``initialize(init=None, ctx=None, verbose=False, force_reinit=False)``:
  each parameter on ``ctx`` (default: the current context) from its own
  initializer where it has one (a bias's ``"zeros"``, a BatchNorm gamma's
  ``"ones"``), else from ``init``; an initialized parameter is left alone
  unless ``force_reinit``. A parameter whose shape is not known yet
  (``Dense(64)``, ``Conv2D(32, 3)``, ``BatchNorm()``) is deferred: at the
  block's first forward the layer's ``_infer_param_shapes`` fills in its
  shape from the input and the initialization finishes there, outside
  autograd's recording. A layer built with ``device=`` and known shapes
  holds construction-time values until ``initialize`` sets them;
- ``cast(dtype)``: every parameter to ``dtype`` through each layer's own
  ``cast`` (a BatchNorm keeps fp32 for 16-bit types), in place; before
  the shapes resolve it sets the dtype they will be made in;
- ``hybridize(active, static_alloc, static_shape)``: keeps the flags and
  runs eagerly, before or after the first forward. The whole training
  step is captured as one CUDA graph per input signature by
  ``Trainer.fuse_step`` (:mod:`mxnet_tpu_torch.step`), which runs the
  block through :func:`functional_call` and resolves deferred shapes at
  its first step;
- ``save_parameters(filename)`` / ``load_parameters(filename, ...)``:
  every parameter under its structural name in MXNet's ``.params`` format
  (:mod:`mxnet_tpu_torch.ndarray.serialization`), so that a file either
  package writes loads in the other bit for bit; loading into a deferred
  block resolves its shapes from the file;
- ``register_child``, ``summary``.

A block takes NDArrays as MXNet's do: ``Block.__call__`` unwraps NDArray
arguments once, runs a layer of the port on their tensors (recorded
inside ``autograd.record()``, under ``torch.no_grad()`` outside it, as
any nd op) and wraps the outputs as NDArrays; the layers inside run plain
torch. Tensors in give tensors out, unchanged. A user block whose
``forward`` overrides only ``Block``'s or ``HybridBlock``'s is written
on NDArrays, as for the JAX package: it is called with NDArrays (tensors
given to it are wrapped, and its outputs unwrapped for such a caller).
A ``HybridBlock`` that defines only ``hybrid_forward(self, F, x, *args,
**params)`` runs it with ``F`` = :mod:`mxnet_tpu_torch.ndarray`, its
inputs as NDArrays and each of its own parameters passed by attribute
name as an NDArray view of the tensor: no copy, and gradients reach it.

Names and the symbolic trace, for ``export`` and ``SymbolBlock``: a block
takes ``prefix=`` and names itself as the JAX package's blocks do (a
per-hint count, ``dense0_``; inside a parent's ``with
parent.name_scope():`` the parent's prefix and a count of its own), and
:meth:`Block.param_name` gives each parameter's name in that naming
(``resnetv10_stage1_conv0_weight``). Called with a ``Symbol``, a block
traces instead of computing: each ported layer's ``_trace(F, x)`` writes
the ops, node names and parameters of the JAX package's
``hybrid_forward``, and a user block's ``hybrid_forward`` runs with ``F``
= :mod:`mxnet_tpu_torch.symbol`. ``export`` writes the traced graph and
the parameters (``arg:``/``aux:``) in files either package reads;
:class:`SymbolBlock` runs such a graph as a block. The torch-direct
forward stays the path for tensors and NDArrays.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional, Union

import torch
from torch import nn

from torch.nn.parameter import UninitializedParameter

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import as_device, resolve_device
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray, _wrap
from ..ops.registry import call_op
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _known, collect_params, param_of)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "as_dtype",
           "functional_call"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"float16"`` (or a ``torch.dtype``) as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} (known: "
                         f"{sorted(_DTYPES)})") from None


def _cast_tree(module: nn.Module, dtype: torch.dtype) -> None:
    """A Block casts itself; a plain module's parameters are cast here and
    its children visited."""
    if isinstance(module, Block):
        module.cast(dtype)
        return
    for attr, p in module.named_parameters(recurse=False):
        param_of(module, attr, p).cast(dtype)
    for child in module.children():
        _cast_tree(child, dtype)


def _unwrap_tree(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_tree(v) for v in x)
    return x


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return _wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_tree(v) for v in x)
    return x


def functional_call(block, args, training=False):
    """``block``'s forward on ``args`` (tensors or NDArrays) over its own
    parameters, recorded for autograd, in training mode if ``training``;
    returns the outputs as a tuple of tensors.

    Counterpart of ``mxnet_tpu/gluon/block.py::functional_call``, reduced
    to what the fused step needs: the parameters are the block's own
    tensors, so no values are substituted, and the aux writes
    (BatchNorm's running statistics) land in their parameters' storage
    by the layers' own in-place copies, where the JAX package returns
    them as values. Inside a captured CUDA graph those copies are part of
    the graph."""
    args = [_unwrap_tree(a) for a in args]
    with autograd._Scope(True, training):
        out = block(*args)
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return tuple(_unwrap_tree(o) for o in outs)


_naming = threading.local()


class _BlockScope:
    """The JAX package's block naming: a top-level block without a prefix
    is ``<hint><n>_`` by a count per hint; one made inside a parent's
    ``name_scope()`` is the parent's prefix plus its own prefix, or plus
    ``<hint><n>_`` by the parent scope's count. An empty prefix makes a
    block whose ``name_scope()`` does nothing.

    A block's :class:`ParameterDict` names its parameters: given
    ``params=`` (another block's ``params``), it takes that dict's prefix
    and shares its parameters, so that ``Dense(..., params=
    embedding.params)`` holds the embedding's weight (a tied decoder);
    otherwise it is the parent's dict's prefix plus the block's own, and
    shares what the parent's dict shares."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """``(prefix, ParameterDict)`` of a new block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                counts = _naming.__dict__.setdefault("counts", {})
                count = counts.get(hint, 0)
                counts[hint] = count + 1
                prefix = f"{hint}{count}_"
            if params is None:
                return prefix, ParameterDict(prefix)
            return prefix, ParameterDict(params.prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if not self._block._empty_prefix:
            self._old_scope = getattr(_BlockScope._current, "value", None)
            _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
            _BlockScope._current.value = self._old_scope


def _is_symbol(x) -> bool:
    from ..symbol.symbol import Symbol
    return isinstance(x, Symbol)


def _hybridize_tree(module: nn.Module, active: bool, **kwargs) -> None:
    for child in module.children():
        if isinstance(child, Block):
            child.hybridize(active, **kwargs)
        else:
            _hybridize_tree(child, active, **kwargs)


_ND_FORWARD: Dict[type, bool] = {}


def _nd_forward(cls) -> bool:
    """Whether ``cls.forward`` is a user's forward on NDArrays: defined
    outside the port (and outside torch), over only the generic
    ``forward`` of ``HybridBlock`` or of torch (a user subclass of a
    ported layer computes on its tensors)."""
    found = _ND_FORWARD.get(cls)
    if found is None:
        definers = [k for k in cls.__mro__ if "forward" in vars(k)]
        own = ("mxnet_tpu_torch", "torch")
        user = not definers[0].__module__.startswith(own)
        ported = [k for k in definers[1:] if k is not HybridBlock
                  and k.__module__.startswith("mxnet_tpu_torch")]
        found = _ND_FORWARD[cls] = user and not ported
    return found


def _pending(module: nn.Module):
    return [(attr, t) for attr, t in module._parameters.items()
            if isinstance(t, UninitializedParameter)]


class Block(nn.Module):
    """A module with the Gluon calls of a model (see the module's
    docstring)."""

    def __init__(self, *args, prefix=None, params=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._scope = _BlockScope(self)

    def _alias(self) -> str:
        return type(self).__name__.lower()

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's)."""
        return self._params

    def name_scope(self):
        """``with block.name_scope():`` blocks made inside are named
        under this one."""
        return self._scope

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # the Parameter stays the attribute (``self.w.data()``); its
            # tensor is registered, for autograd, ``hybrid_forward`` and
            # collection
            self._parameters.pop(name, None)
            object.__setattr__(self, name, value)
            self._parameters[name] = value.tensor
            self._params.setdefault(value.name, value)
            return
        if name in self.__dict__ and isinstance(self.__dict__[name],
                                                 Parameter):
            del self.__dict__[name]
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def _new_param(self, attr, shape, dtype=torch.float32, init=None,
                   device=None, grad_req="write", differentiable=True,
                   allow_deferred_init=True, **kwargs) -> nn.Parameter:
        """Make this layer's parameter ``attr`` (named as
        :meth:`param_name` names it) and return its tensor, to be assigned
        as the attribute. With ``device`` and a known shape it holds
        construction-time values there; otherwise it waits for
        ``initialize`` (and, with a 0 in ``shape``, the first forward).
        A parameter of that name that the block's ``params`` share (see
        :class:`_BlockScope`) is returned instead, its unknown dimensions
        filled from ``shape``."""
        renames = getattr(self, "_JAX_NAMES", None) or {}
        name = self._params.prefix + renames.get(attr, attr)
        shared = self._params._get_impl(name)
        if shared is not None:
            old = shared.shape
            if old is not None and len(old) == len(shape):
                shape = tuple(n or o for o, n in zip(old, shape))
            shared.shape = shape
            return shared.tensor
        p = Parameter(name, grad_req=grad_req, shape=shape,
                      dtype=as_dtype(dtype), init=init,
                      allow_deferred_init=allow_deferred_init,
                      differentiable=differentiable, **kwargs)
        self._params[p.name] = p
        if device is not None:
            p._device = resolve_device(device)
            if all(s > 0 for s in p.shape):
                p._materialize_now(p._device)
        return p.tensor

    def param(self, attr: str) -> Parameter:
        """The :class:`Parameter` of this block's tensor ``attr``."""
        return param_of(self, attr, self._parameters[attr])

    def param_name(self, attr: str) -> str:
        """The JAX package's name of this block's parameter ``attr``
        (``weight``, or a normalization layer's ``gamma`` for the port's
        ``weight``)."""
        t = self._parameters.get(attr)
        p = None if t is None else t.__dict__.get("_mx_param")
        if p is not None:
            return p.name
        renames = getattr(self, "_JAX_NAMES", None) or {}
        return self._prefix + renames.get(attr, attr)

    def named_jax_params(self) -> Dict[str, nn.Parameter]:
        """``{JAX package name: tensor}`` in the naming of
        :meth:`param_name`, the names ``export`` writes."""
        return {name: p.tensor for name, p in self.collect_params().items()}

    def _param_vars(self) -> Dict[str, object]:
        """A variable for each parameter of this block, by attribute."""
        from ..symbol.symbol import var
        return {attr: var(self.param_name(attr))
                for attr, p in self._parameters.items() if p is not None}

    def _symbol_call(self, *args):
        trace = getattr(self, "_trace", None)
        if trace is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no symbolic trace; export "
                "traces the ported layers and blocks that define "
                "hybrid_forward")
        from .. import symbol as sym_ns
        return trace(sym_ns, *args)

    def _resolve_deferred(self, args) -> None:
        """Finish the deferred initialization of this block's own
        parameters from the first input's shapes (the JAX package's
        ``_deferred_infer_shape``)."""
        pending = [param_of(self, a, t) for a, t in _pending(self)]
        if not pending:
            return
        if not all(_known(p.shape) for p in pending):
            infer = getattr(self, "_infer_param_shapes", None)
            if infer is None:
                raise MXNetError(
                    f"Deferred initialization failed for {self.name}: "
                    "layer does not implement shape inference")
            infer(*[_unwrap_tree(a) for a in args])
        for p in pending:
            p._finish_deferred_init()
            p._check_initialized()

    def __call__(self, *args, **kwargs):
        if any(_is_symbol(a) for a in args):
            return self._symbol_call(*args)
        if self._parameters and _pending(self):
            self._resolve_deferred(args)
        if _nd_forward(type(self)):
            tensors = any(isinstance(a, torch.Tensor) for a in args)
            out = self.forward(*[_wrap_tree(a) for a in args],
                               **{k: _wrap_tree(v) for k, v in
                                  kwargs.items()})
            return _unwrap_tree(out) if tensors else out
        for a in args:
            if isinstance(a, NDArray):
                break
        else:
            if not kwargs or not any(isinstance(v, NDArray)
                                     for v in kwargs.values()):
                return super().__call__(*args, **kwargs)
        args = [_unwrap_tree(a) for a in args]
        kwargs = {k: _unwrap_tree(v) for k, v in kwargs.items()}
        out = call_op(super().__call__, autograd.is_recording(), *args,
                      **kwargs)
        return _wrap_tree(out)

    def register_child(self, block, name=None):
        """Register ``block`` as a child (named by its index unless
        ``name``)."""
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Every parameter of this block and its children under its
        prefixed name (the JAX package's keys and order); ``select`` keeps
        the names a regular expression matches from their start."""
        pattern = re.compile(select) if select else None
        ret = ParameterDict(self._prefix)
        for mod in self.modules():
            for attr, t in mod.named_parameters(recurse=False):
                p = param_of(mod, attr, t)
                if pattern is None or pattern.match(p.name):
                    ret.update({p.name: p})
        return ret

    def _collect_params_with_prefix(self, prefix="") -> Dict[str, Parameter]:
        """``{structural name: Parameter}`` (``0.weight``,
        ``features.1.gamma``), as ``.params`` files name them."""
        owner = {}
        for mod in self.modules():
            for attr, t in mod.named_parameters(recurse=False):
                owner.setdefault(id(t), (mod, attr))
        head = prefix + "." if prefix else ""
        return {head + name: param_of(*owner[id(t)], t)
                for name, t in collect_params(self).items()}

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (see the module's
        docstring)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        dtype = as_dtype(dtype)
        for child in self.children():
            _cast_tree(child, dtype)
        for attr, p in self._parameters.items():
            if p is not None:
                param_of(self, attr, p).cast(dtype)

    def hybridize(self, active=True, **kwargs):
        _hybridize_tree(self, active, **kwargs)

    def summary(self, *inputs):
        """Print each block's name, type and parameter count, children
        indented under their parent; with ``inputs``, one forward (not
        recorded) resolves deferred shapes first."""
        if inputs:
            with autograd.pause():
                self(*inputs)
        rows = []

        def walk(block, depth):
            n = 0
            for attr, t in block._parameters.items():
                if t is not None:
                    shape = block.param(attr).shape
                    n += math.prod(shape) if shape else 0
            rows.append(("  " * depth + block.name, type(block).__name__,
                         n))
            for child in block.children():
                if isinstance(child, Block):
                    walk(child, depth + 1)

        walk(self, 0)
        print(f"{'Layer':<40}{'Type':<24}{'Params':<12}")
        print("-" * 76)
        for name, type_, n in rows:
            print(f"{name:<40}{type_:<24}{n:<12}")
        print("-" * 76)
        print(f"Parameters in total: {sum(r[2] for r in rows)}")

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter, under its structural name, to
        ``filename`` in MXNet's format."""
        serialization.save(filename, {
            name: p.data()._data.detach()
            for name, p in self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a file :meth:`save_parameters` (of
        either package) wrote. A parameter absent from the file raises
        unless ``allow_missing``; a name the model lacks raises unless
        ``ignore_extra``. Values take each parameter's dtype, as in the
        JAX package, unless ``cast_dtype`` with ``dtype_source="saved"``,
        where the parameter takes the file's. A deferred parameter takes
        the file's shape and finishes its initialization; one never
        initialized is made on ``ctx`` (default: the current context).
        ``ctx`` moves every loaded parameter there; else each stays on its
        device. A resolved shape that differs raises."""
        loaded = serialization.load(filename, device="cpu")
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
        dev = None if ctx is None else resolve_device(ctx)
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter '{name}' loaded from file "
                        f"'{filename}' is not present in Block")
                continue
            param = params[name]
            param.shape = tuple(value.shape)
            if isinstance(param.tensor, UninitializedParameter):
                if not param._deferred_init:
                    param.initialize(ctx=ctx)
                param._finish_deferred_init()
            if cast_dtype and dtype_source == "saved":
                param.cast(value.dtype)
            if dev is not None and param.tensor.device != dev:
                param.reset_ctx(dev)
            param.set_data(value)

    save_params = save_parameters
    load_params = load_parameters


class HybridBlock(Block):
    """A Block that may be hybridized; in the port it keeps the flags and
    runs eagerly. A subclass defines ``forward`` on tensors, or
    ``hybrid_forward(F, x, *args, **params)`` on NDArrays (see the
    module's docstring)."""

    def _trace(self, F, x, *args):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(
                f"{type(self).__name__} has no symbolic trace; export "
                "traces the ported layers and blocks that define "
                "hybrid_forward")
        return self.hybrid_forward(F, x, *args, **self._param_vars())

    def export(self, path, epoch=0, remove_amp_cast=True):
        """``path-symbol.json`` (the traced graph of one input,
        ``data``) and ``path-%04d.params`` (every parameter under its JAX
        package name, ``aux:`` for the graph's aux states, else ``arg:``),
        which ``SymbolBlock.imports`` and ``Module.load`` of either
        package read. Every parameter must be resolved: run one forward
        first where shapes were deferred."""
        for name, p in self.collect_params().items():
            try:
                p._check_initialized()
            except DeferredInitializationError as e:
                raise MXNetError("export requires resolved parameter "
                                 "shapes; run one forward pass before "
                                 "export") from e
        sym = self._trace_symbol()
        sym.save(f"{path}-symbol.json")
        aux_names = set(sym.list_auxiliary_states())
        serialization.save("%s-%04d.params" % (path, epoch), {
            f"{'aux' if name in aux_names else 'arg'}:{name}": p.detach()
            for name, p in self.named_jax_params().items()})
        return sym

    def _trace_symbol(self):
        from ..symbol.symbol import var
        return self(var("data"))

    def forward(self, x, *args):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            # a block whose forward comes from another base (a
            # HybridSequential's from nn.Sequential); a bare module raises
            return super().forward(x, *args)
        from .. import ndarray as nd
        params = {name: _wrap(p) for name, p in self._parameters.items()
                  if p is not None}
        out = self.hybrid_forward(nd, _wrap_tree(x),
                                  *[_wrap_tree(a) for a in args], **params)
        return _unwrap_tree(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def __init__(self, *args, prefix=None, params=None, **kwargs):
        super().__init__(*args, prefix=prefix, params=params, **kwargs)
        self._active = False
        self._flags: Dict[str, bool] = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)


class SymbolBlock(HybridBlock):
    """A graph and its parameters as a block: the counterpart of the JAX
    package's ``SymbolBlock``. ``outputs`` is the graph (a Symbol or a
    list of them), ``inputs`` its input variables; every other argument
    and aux state of the graph is a parameter of the block under its
    graph name (aux states with ``requires_grad=False``), which
    :meth:`collect_params` gives. Calling it runs the graph with
    :func:`~mxnet_tpu_torch.symbol.symbol.eval_graph`: in training
    (``autograd.is_training()``) it writes the aux states it updates back
    into their parameters. Parameters not given (``params``, or the file
    of :meth:`imports`) are made at the first call from the inputs'
    shapes, and filled by :class:`~mxnet_tpu_torch.initializer.Uniform`.
    """

    def __init__(self, outputs, inputs, params=None, device=None):
        super().__init__(prefix="")
        from ..symbol.symbol import Group
        if isinstance(outputs, (list, tuple)):
            outputs = Group(outputs)
        if _is_symbol(inputs):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        self._aux_names = set(outputs.list_auxiliary_states())
        self._param_names = [n for n in outputs.list_arguments()
                             if n not in self._input_names] + \
            outputs.list_auxiliary_states()
        self._device = device
        self._graph_params = nn.ParameterDict()
        for name, value in (params or {}).items():
            self._set_param(name, value)

    def _set_param(self, name, value: torch.Tensor) -> None:
        if name not in self._param_names:
            return
        t = value.detach()
        if self._device is not None:
            t = t.to(resolve_device(self._device))
        t = nn.Parameter(t.clone(), requires_grad=name not in self._aux_names)
        self._graph_params[name] = t
        param_of(self._graph_params, name, t)._initialized = True

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of a graph file (and a ``.params`` file with
        ``arg:``/``aux:`` names) on ``ctx`` (default: the current
        context)."""
        from ..context import as_device
        from ..symbol import symbol as sym_mod
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        dev = as_device(ctx)
        params = {}
        if param_file is not None:
            loaded = serialization.load(param_file, device="cpu")
            params = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
        return SymbolBlock(sym, [sym_mod.var(n) for n in input_names],
                           params, device=dev)

    def collect_params(self, select=None):
        pattern = re.compile(select) if select else None
        ret = ParameterDict("")
        ret.update({n: param_of(self._graph_params, n, p)
                    for n, p in self._graph_params.items()
                    if pattern is None or pattern.match(n)})
        return ret

    def named_jax_params(self):
        return dict(self._graph_params.items())

    def _trace_symbol(self):
        return self._symbol

    def _trace(self, F, *args):
        raise MXNetError("composing an imported SymbolBlock into another "
                         "symbolic trace is not supported; export it "
                         "(it writes its stored graph)")

    def _make_missing(self, values) -> None:
        missing = [n for n in self._param_names
                   if n not in self._graph_params]
        if not missing:
            return
        from ..symbol.symbol import _infer_all_shapes
        shapes = _infer_all_shapes(self._symbol, {
            n: tuple(v.shape) for n, v in values.items()})
        dev = next(iter(values.values())).device
        init = init_mod.Uniform()
        for n in missing:
            t = torch.zeros(shapes[n], device=dev)
            init(init_mod.InitDesc(n), t)
            self._graph_params[n] = nn.Parameter(
                t, requires_grad=n not in self._aux_names)

    def forward(self, *args):
        from ..symbol.symbol import eval_graph
        values = dict(zip(self._input_names, args))
        self._make_missing(values)
        values.update(self._graph_params.items())
        training = autograd.is_training()
        dev = args[0].device if args else None
        outs, aux = eval_graph(self._symbol, values, training, dev)
        with torch.no_grad():
            for name, v in aux.items():
                if name in self._graph_params:
                    self._graph_params[name].copy_(v)
        return outs[0] if len(outs) == 1 else list(outs)
