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
  input signature is the fused-step slice (ROADMAP Queue A item 4).

``save_parameters``/``load_parameters``, ``export`` and ``summary`` are
not ported yet; ``state_dict`` and ``convert.py`` carry weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from .. import initializer as init_mod
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


def _hybridize_tree(module: nn.Module, active: bool, **kwargs) -> None:
    for child in module.children():
        if isinstance(child, Block):
            child.hybridize(active, **kwargs)
        else:
            _hybridize_tree(child, active, **kwargs)


class Block(nn.Module):
    """A module with the Gluon calls of a model (see the module's
    docstring)."""

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


class HybridBlock(Block):
    """A Block that may be hybridized; in the port it keeps the flags and
    runs eagerly."""

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
