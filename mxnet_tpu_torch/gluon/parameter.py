"""Gluon's parameters: ``Parameter``, ``Constant``, ``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py``. A :class:`Parameter`
holds one ``torch.nn.Parameter`` (:attr:`Parameter.tensor`), which is the
leaf autograd reaches, the attribute a layer computes with
(``dense.weight`` is the tensor; ``dense.weight._mx_param`` its
Parameter) and what a Trainer, an optimizer state or a fused step keys
by identity and storage. The tensor is made once, with the Parameter,
and keeps its identity for the Parameter's life: until the values exist
it is a ``torch.nn.parameter.UninitializedParameter``, and
``materialize`` turns that same object into a ``Parameter`` of the
resolved shape, device and dtype. A cast or a move rebinds its
``.data``.

A shape may hold 0 for a dimension not known yet (``Dense(64)``'s
``(64, 0)``). :meth:`Parameter.initialize` on such a parameter defers:
it keeps the initializer and the device (``ctx``, else
:func:`~mxnet_tpu_torch.context.current_context`, which is ``gpu(0)``
unless a ``with mx.cpu():`` scope says otherwise), and the layer's first
forward fills the shape in (its ``_infer_param_shapes``) and finishes the
initialization, outside autograd's recording. Until then :meth:`data`
raises :class:`DeferredInitializationError` with the JAX package's
message.

The Gluon attributes live on the tensor, where the port's Trainer,
optimizers and fused step read them: ``grad_req`` (``"null"`` is
``requires_grad=False``; ``"add"`` accumulates), ``lr_mult``,
``wd_mult``, ``stype``/``grad_stype`` (stored; the gradient is dense
whatever they say, as in ``mxnet_tpu/gluon/parameter.py``).

Naming: a parameter's :attr:`Parameter.name` is its block's prefix and
its own name (``dense0_weight``), the key of ``Block.collect_params()``.
:func:`collect_params` gives a module's tensors under their structural
names (``0.weight``, ``features.1.running_var``), the keys of the JAX
package's ``_collect_params_with_prefix()``, of ``.params`` files and of
``convert.py``.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import initializer as init_mod
from ..base import MXNetError
from ..context import Context, as_device
from ..ndarray.ndarray import _wrap, as_torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "collect_params", "JAX_NAMES",
           "param_of"]

# a normalization layer's parameters (LayerNorm, BatchNorm, InstanceNorm,
# GroupNorm): the port's (PyTorch's) name -> the JAX package's; a layer
# class that uses them says so in its ``_JAX_NAMES``
JAX_NAMES = {"weight": "gamma", "bias": "beta"}

_DTYPE_NAMES = {torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int32: "int32", torch.int64: "int64",
                torch.bool: "bool"}


class DeferredInitializationError(MXNetError):
    """A parameter's data was asked for before its first forward
    resolved its shape."""


def row_sparse_grad(grad):
    """A torch sparse gradient as a ``RowSparseNDArray``, for the
    optimizers' lazy updates; a dense one as it is."""
    if not grad.is_sparse:
        return grad
    from ..ndarray.sparse_ops import SparseCotangent
    return SparseCotangent.from_coo(grad).to_rowsparse()


def _is_uninit(t) -> bool:
    return isinstance(t, UninitializedParameter)


def _known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A parameter of a block (see the module's docstring). ``tensor``
    wraps an existing ``torch.nn.Parameter`` (its values count as set by
    an earlier initialization only once :meth:`initialize` ran)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", tensor=None):
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._deferred_init = ()
        self._initialized = False
        self._device = None  # where a layer built with device= wants it
        self._var = None
        if tensor is None:
            self._dtype = as_torch_dtype(dtype)
            tensor = UninitializedParameter(
                requires_grad=differentiable and grad_req != "null",
                dtype=self._dtype)
        else:
            self._dtype = tensor.dtype
            if not _is_uninit(tensor):
                self._shape = tuple(tensor.shape)
        self._tensor = tensor
        tensor._mx_param = self
        self.grad_req = grad_req if differentiable else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        tensor.stype, tensor.grad_stype = stype, grad_stype

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    # -- attributes, stored on the tensor ---------------------------------
    @property
    def tensor(self) -> nn.Parameter:
        """The ``torch.nn.Parameter`` (uninitialized until resolved)."""
        return self._tensor

    @property
    def grad_req(self) -> str:
        t = self._tensor
        return getattr(t, "grad_req", "write") if t.requires_grad \
            else "null"

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be one of 'write', 'add', or "
                             f"'null', but got '{req}'")
        if not self._differentiable:
            req = "null"
        t = self._tensor
        if t.requires_grad != (req != "null"):
            t.requires_grad = req != "null"
            if req == "null" and not _is_uninit(t):
                t.grad = None
        t.grad_req = req

    @property
    def lr_mult(self):
        return self._tensor.lr_mult

    @lr_mult.setter
    def lr_mult(self, v):
        self._tensor.lr_mult = v

    @property
    def wd_mult(self):
        return self._tensor.wd_mult

    @wd_mult.setter
    def wd_mult(self, v):
        self._tensor.wd_mult = v

    @property
    def stype(self):
        return self._tensor.stype

    @property
    def grad_stype(self):
        return self._tensor.grad_stype

    @property
    def dtype(self) -> str:
        return _DTYPE_NAMES.get(self._dtype, str(self._dtype))

    @property
    def shape(self):
        if not _is_uninit(self._tensor):
            return tuple(self._tensor.shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape or None
            return
        if len(self._shape) != len(new_shape) or not all(
                s == 0 or s == n for s, n in zip(self._shape, new_shape)):
            raise MXNetError(
                f"Expected shape {self._shape} is incompatible with given "
                f"shape {new_shape} for Parameter {self.name}")
        self._shape = new_shape

    # -- initialization ---------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the parameter on ``ctx`` (a Context or a device; a list
        gives its first; None: where it is, or where its layer was built,
        else :func:`current_context`) by ``init``, else
        its own initializer, else ``default_init`` (Uniform). An
        initialized parameter is left alone unless ``force_reinit``. With
        a shape not known yet it defers to the first forward where
        ``allow_deferred_init``, and raises otherwise."""
        default_init = default_init or init_mod.Uniform()
        if self._initialized and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        if ctx is not None:
            device = as_device(ctx)
        elif not _is_uninit(self._tensor):
            device = self._tensor.device
        else:
            device = self._device or as_device(None)
        if not _known(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise MXNetError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape: {self._shape}.")
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init):
        t = self._tensor
        with torch.no_grad():
            if _is_uninit(t):
                t.materialize(self._shape, device=device, dtype=self._dtype)
            elif t.device != device:
                self._move(device)
            initializer = init or self.init or default_init
            init_mod.create(initializer)(init_mod.InitDesc(self.name),
                                         t.data)
        self._deferred_init = ()
        self._initialized = True

    def _finish_deferred_init(self):
        """Finish a deferred :meth:`initialize` once the shape is known
        (nothing to do where none was deferred)."""
        if not self._deferred_init:
            return
        if not _known(self.shape):
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape")
        self._finish_init(*self._deferred_init)

    def _materialize_now(self, device):
        """Give a parameter of known shape values on ``device`` at
        construction (a layer built with ``device=``): its own
        initializer's, or U(-0.07, 0.07) from torch's global generator
        where it has none. It counts as not yet initialized, so the first
        ``initialize`` still fills it."""
        t = self._tensor
        self._device = device
        with torch.no_grad():
            t.materialize(self._shape, device=device, dtype=self._dtype)
            if self.init is None:
                nn.init.uniform_(t, -0.07, 0.07)
            else:
                init_mod.create(self.init)(self.name, t.data)

    def _check_initialized(self):
        if not _is_uninit(self._tensor):
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because "
                f"initialization was deferred. Actual initialization happens "
                f"during the first forward pass.")
        raise MXNetError(
            f"Parameter {self.name} has not been initialized. You should "
            f"initialize parameters with Block.initialize().")

    # -- data and gradient ------------------------------------------------
    def data(self, ctx=None):
        """The values as an NDArray over the tensor (no copy)."""
        self._check_initialized()
        return _wrap(self._tensor)

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient as an NDArray over the tensor's ``.grad`` (zeros
        where no backward wrote one yet); a sparse one (``contrib.nn.
        SparseEmbedding``'s weight) as a ``RowSparseNDArray``."""
        self._check_initialized()
        t = self._tensor
        if not t.requires_grad:
            raise MXNetError(
                f"Cannot get gradient array for Parameter {self.name} "
                f"because grad_req='null'")
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        if t.grad.is_sparse:
            return row_sparse_grad(t.grad)
        return _wrap(t.grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [Context("cpu" if self._tensor.device.type == "cpu"
                        else "gpu", self._tensor.device.index or 0)]

    def set_data(self, data):
        """Copy ``data`` (an NDArray, a tensor or an array) in, cast to
        the parameter's dtype; a deferred parameter takes its shape."""
        value = getattr(data, "_data", data)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self.shape = tuple(value.shape)
        if _is_uninit(self._tensor):
            if not self._deferred_init:
                raise MXNetError(
                    f"Parameter {self.name} has not been initialized")
            self._finish_deferred_init()
        t = self._tensor
        with torch.no_grad():
            t.copy_(value.to(device=t.device, dtype=t.dtype))

    def zero_grad(self):
        g = self._tensor.grad
        if g is not None:
            with torch.no_grad():
                g.zero_()

    def _move(self, device):
        t = self._tensor
        with torch.no_grad():
            t.data = t.data.to(device)
            if t.grad is not None:
                t.grad = t.grad.to(device)

    def reset_ctx(self, ctx):
        """Move the parameter (or its deferred initialization) to
        ``ctx``."""
        device = as_device(ctx)
        if self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, device, default_init)
        elif not _is_uninit(self._tensor):
            self._move(device)

    def cast(self, dtype):
        """Cast to ``dtype``; before the shape resolves, the dtype the
        values will be made in."""
        self._dtype = as_torch_dtype(dtype)
        t = self._tensor
        if _is_uninit(t):
            return
        with torch.no_grad():
            t.data = t.data.to(self._dtype)
            if t.grad is not None:
                t.grad = t.grad.to(self._dtype)

    def var(self):
        """The parameter as a symbol variable."""
        if self._var is None:
            from ..symbol.symbol import var
            self._var = var(self.name, shape=self.shape, dtype=self.dtype)
        return self._var


class Constant(Parameter):
    """A parameter of fixed value, never trained (``grad_req="null"``)."""

    def __init__(self, name, value):
        value = getattr(value, "_data", value)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self.value = value

        class _InitConst(init_mod.Initializer):
            def _init_weight(self, _, arr):
                with torch.no_grad():
                    arr.copy_(value.to(device=arr.device, dtype=arr.dtype))

        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=_DTYPE_NAMES.get(value.dtype, "float32"),
                         init=_InitConst())


class ParameterDict(dict):
    """``{name: Parameter}`` under a prefix: what ``Block.params`` and
    ``Block.collect_params()`` are. :meth:`get` makes (or returns) the
    parameter ``prefix + name``."""

    def __init__(self, prefix="", shared=None):
        super().__init__()
        self._prefix = prefix
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join(repr(p) for p in self.values())
        return f"ParameterDict ({self._prefix})\n{s}"

    def get(self, name, **kwargs) -> Parameter:
        """The parameter ``prefix + name``, made with ``kwargs`` where it
        does not exist yet; on an existing one, a shape fills in its
        unknown dimensions and an unset attribute is set."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = self[name] = Parameter(name, **kwargs)
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = v
                elif getattr(param, k, None) is None:
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(name)
            param = self[name] = Constant(name, value)
        return param

    def _get_impl(self, name):
        if name in self:
            return self[name]
        if self._shared is not None and name in self._shared:
            self[name] = self._shared[name]
            return self[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self and self[k] is not v:
                raise ValueError(f"Cannot update self with other because they"
                                 f" have different Parameters with the same "
                                 f"name {k}")
            self[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (each by its own initializer where
        it has one, else ``init``; Uniform by default)."""
        default = init_mod.create(init) if init is not None \
            else init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) on every
        parameter."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import serialization
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(f"Prefix '{strip_prefix}' is to be stripped "
                                 f"but Parameter's name '{param.name}' does "
                                 f"not start with it")
            arg_dict[param.name[len(strip_prefix):]] = \
                param.data()._data.detach()
        serialization.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import serialization
        loaded = serialization.load(filename, device="cpu")
        arg_dict = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError(f"Parameter {name} is missing in file "
                                     f"{filename}")
        for name, value in arg_dict.items():
            if name not in self:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name} loaded from file {filename} is "
                        "not present in ParameterDict")
                continue
            param = self[name]
            if _is_uninit(param.tensor) and not param._deferred_init:
                param.shape = tuple(value.shape)
                param.initialize(ctx=ctx)
            param.set_data(value)


def param_of(module: nn.Module, attr: str, tensor) -> Parameter:
    """The :class:`Parameter` of ``module``'s tensor ``attr``: the one it
    was made with, or one made now around a tensor made otherwise (a
    ``torch.nn.Parameter`` a user block assigns), named by the block."""
    p = tensor.__dict__.get("_mx_param")
    if p is None:
        name_of = getattr(module, "param_name", None)
        name = name_of(attr) if name_of is not None else attr
        req = getattr(tensor, "grad_req", "write") if tensor.requires_grad \
            else "null"
        p = Parameter(name, grad_req=req,
                      init=getattr(tensor, "_mx_init", None),
                      lr_mult=getattr(tensor, "lr_mult", 1.0),
                      wd_mult=getattr(tensor, "wd_mult", 1.0),
                      stype=getattr(tensor, "stype", "default"),
                      grad_stype=getattr(tensor, "grad_stype", "default"),
                      tensor=tensor)
    return p


def collect_params(module: nn.Module, select: Optional[str] = None
                   ) -> Dict[str, nn.Parameter]:
    """``{structural name: tensor}`` of ``module``, in module order
    (``layers.0.attn.qkv.weight``, ``ln_f.gamma``,
    ``features.1.running_mean``, ...): the JAX package's
    ``_collect_params_with_prefix()`` names, over the port's tensors.
    ``select`` keeps the names a regular expression matches from their
    start (``re.match``)."""
    pattern = re.compile(select) if select else None
    out: "OrderedDict[str, nn.Parameter]" = OrderedDict()
    for mod_name, mod in module.named_modules():
        renames = getattr(mod, "_JAX_NAMES", None) or {}
        for p_name, p in mod.named_parameters(recurse=False):
            p_name = renames.get(p_name, p_name)
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if pattern is None or pattern.match(name):
                out[name] = p
    return out
