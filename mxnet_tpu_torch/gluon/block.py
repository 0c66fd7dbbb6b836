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
  runs eagerly. Capture of the forward and the step into one program per
  input signature is the fused-step slice (ROADMAP Queue A item 3).

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

``export`` and ``summary`` are not ported yet (ROADMAP Queue A item 2).
"""
from __future__ import annotations

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

__all__ = ["Block", "HybridBlock", "as_dtype"]

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


def _hybridize_tree(module: nn.Module, active: bool, **kwargs) -> None:
    for child in module.children():
        if isinstance(child, Block):
            child.hybridize(active, **kwargs)
        else:
            _hybridize_tree(child, active, **kwargs)


class Block(nn.Module):
    """A module with the Gluon calls of a model (see the module's
    docstring)."""

    def __call__(self, *args, **kwargs):
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

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._active = False
        self._flags: Dict[str, bool] = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)
