"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``'s ``Block`` and
``HybridBlock``: the Gluon calls a training script makes on a model,
over a module whose parameters exist from the start (shapes are given up
front, so there is no deferred initialization):

- ``collect_params(select=None)``: ``{name: parameter}`` under the JAX
  package's names (:func:`~mxnet_tpu_torch.gluon.parameter.collect_params`);
- ``initialize(init=Uniform(), force_reinit=False)``: each parameter from
  its own initializer where it has one (a bias's ``"zeros"``, a BatchNorm
  gamma's ``"ones"``), else from ``init``; a parameter that an earlier
  ``initialize`` set is left alone unless ``force_reinit``. Until then a
  layer holds its construction-time defaults;
- ``cast(dtype)``: every parameter to ``dtype`` through each layer's own
  ``cast`` (a BatchNorm keeps fp32 for 16-bit types), in place, so a
  Trainer made afterwards sees the cast tensors;
- ``hybridize(active, static_alloc, static_shape)``: keeps the flags and
  runs eagerly. The whole training step is captured as one CUDA graph per
  input signature by ``Trainer.fuse_step`` (:mod:`mxnet_tpu_torch.step`),
  which runs the block through :func:`functional_call`.

- ``save_parameters(filename)`` / ``load_parameters(filename, ...)``:
  every parameter under those names in MXNet's ``.params`` format
  (:mod:`mxnet_tpu_torch.ndarray.serialization`), so that a file either
  package writes loads in the other bit for bit.

A block takes NDArrays as MXNet's do: ``Block.__call__`` unwraps NDArray
arguments once, runs the block on their tensors (recorded inside
``autograd.record()``, under ``torch.no_grad()`` outside it, as any nd op)
and wraps the outputs as NDArrays; the layers inside run plain torch.
Tensors in give tensors out, unchanged. A ``HybridBlock`` that defines
only ``hybrid_forward(self, F, x, *args, **params)`` runs it with ``F`` =
:mod:`mxnet_tpu_torch.ndarray`, its inputs as NDArrays and each of its
own parameters (``torch.nn.Parameter`` attributes, made with
:func:`~mxnet_tpu_torch.gluon.parameter.make_param` or directly) passed
by name as an NDArray view of the parameter: no copy, and gradients reach
it.

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
forward stays the path for tensors and NDArrays. ``summary`` is not
ported yet (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch
from torch import nn

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray, _wrap
from ..ops.registry import call_op
from .parameter import collect_params

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


def _cast_param(p: nn.Parameter, dtype: torch.dtype) -> None:
    with torch.no_grad():
        p.data = p.data.to(dtype)
        if p.grad is not None:
            p.grad = p.grad.to(dtype)


def _cast_tree(module: nn.Module, dtype: torch.dtype) -> None:
    """A Block casts itself; a plain module's parameters are cast here and
    its children visited."""
    if isinstance(module, Block):
        module.cast(dtype)
        return
    for p in module.parameters(recurse=False):
        _cast_param(p, dtype)
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
    block whose ``name_scope()`` does nothing."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, hint) -> str:
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                counts = _naming.__dict__.setdefault("counts", {})
                count = counts.get(hint, 0)
                counts[hint] = count + 1
                prefix = f"{hint}{count}_"
            return prefix
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        return current._block.prefix + prefix

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


class Block(nn.Module):
    """A module with the Gluon calls of a model (see the module's
    docstring)."""

    def __init__(self, *args, prefix=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._empty_prefix = prefix == ""
        self._prefix = _BlockScope.create(prefix, self._alias())
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

    def name_scope(self):
        """``with block.name_scope():`` blocks made inside are named
        under this one."""
        return self._scope

    def param_name(self, attr: str) -> str:
        """The JAX package's name of this block's parameter ``attr``
        (``weight``, or a normalization layer's ``gamma`` for the port's
        ``weight``)."""
        renames = getattr(self, "_JAX_NAMES", None) or {}
        return self._prefix + renames.get(attr, attr)

    def named_jax_params(self) -> Dict[str, nn.Parameter]:
        """``{JAX package name: parameter}`` in the naming of
        :meth:`param_name`, the names ``export`` writes."""
        out = {}
        for mod in self.modules():
            if not isinstance(mod, Block):
                continue
            for attr, p in mod.named_parameters(recurse=False):
                out[mod.param_name(attr)] = p
        return out

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

    def __call__(self, *args, **kwargs):
        if any(_is_symbol(a) for a in args):
            return self._symbol_call(*args)
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

    def collect_params(self, select: Optional[str] = None
                       ) -> Dict[str, nn.Parameter]:
        return collect_params(self, select)

    def initialize(self, init=None, force_reinit=False):
        default = init_mod.create(init) if init is not None \
            else init_mod.Uniform()
        for name, p in self.collect_params().items():
            if getattr(p, "_mx_initialized", False) and not force_reinit:
                continue
            own = getattr(p, "_mx_init", None)
            (default if own is None else init_mod.create(own))(name, p.data)
            p._mx_initialized = True

    def cast(self, dtype):
        dtype = as_dtype(dtype)
        for child in self.children():
            _cast_tree(child, dtype)
        for p in self.parameters(recurse=False):
            _cast_param(p, dtype)

    def hybridize(self, active=True, **kwargs):
        _hybridize_tree(self, active, **kwargs)

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter, named as :meth:`collect_params` names
        them, to ``filename`` in MXNet's format."""
        serialization.save(filename, {name: p.detach() for name, p in
                                      self.collect_params().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a file :meth:`save_parameters` (of
        either package) wrote. A parameter absent from the file raises
        unless ``allow_missing``; a name the model lacks raises unless
        ``ignore_extra``. Values take each parameter's dtype, as in the
        JAX package, unless ``cast_dtype`` with ``dtype_source="saved"``,
        where the parameter takes the file's. ``ctx`` (a device) moves
        every loaded parameter there; else each stays on its device.
        Shapes are fixed when a layer is built, so a shape that differs
        raises."""
        loaded = serialization.load(filename, device="cpu")
        params = self.collect_params()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
        dev = None if ctx is None else resolve_device(ctx)
        with torch.no_grad():
            for name, value in loaded.items():
                if name not in params:
                    if not ignore_extra:
                        raise MXNetError(
                            f"Parameter '{name}' loaded from file "
                            f"'{filename}' is not present in Block")
                    continue
                p = params[name]
                if tuple(value.shape) != tuple(p.shape):
                    raise MXNetError(
                        f"Parameter '{name}' has shape {tuple(p.shape)}, "
                        f"the file's is {tuple(value.shape)}")
                dtype = value.dtype if cast_dtype and \
                    dtype_source == "saved" else p.dtype
                target = p.device if dev is None else dev
                if target == p.device and dtype == p.dtype:
                    p.data.copy_(value)
                else:
                    p.data = value.to(device=target, dtype=dtype)

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
        package read."""
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

    def __init__(self, *args, prefix=None, **kwargs):
        super().__init__(*args, prefix=prefix, **kwargs)
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
        self._graph_params[name] = nn.Parameter(
            t.clone(), requires_grad=name not in self._aux_names)

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
        import re
        pattern = re.compile(select) if select else None
        return {n: p for n, p in self._graph_params.items()
                if pattern is None or pattern.match(n)}

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
