"""Basic layers as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``InstanceNorm``, ``LayerNorm``, ``GroupNorm``, ``Embedding``,
``Flatten``, ``Lambda``, ``HybridLambda``, ``Activation`` and the
activation layers ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``Swish``,
``GELU``, with the JAX package's arguments. An input size left at 0
(``Dense(64)``'s ``in_units``, a normalization layer's ``in_channels``)
is resolved at the first forward (``_infer_param_shapes``); the layers
that are told every size and built with ``device=`` hold usable values
from construction (a weight U(-0.07, 0.07), the JAX package's default
initializer, from torch's global generator; biases, gammas and running
statistics from their own initializers) until ``Block.initialize`` sets
them. Without ``device=`` the parameters are made by ``initialize`` on its
``ctx``. Parameter layouts match the JAX package, so weights carry over
one to one (``convert.py``): a ``Dense`` weight is ``(units, in_units)``,
the layout of ``torch.nn.Linear``; a normalization layer's
``gamma``/``beta`` are ``weight``/``bias`` here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import autograd
from ... import initializer as init_mod
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as nn_ops
from ..block import Block, HybridBlock, _unwrap_tree, _wrap_tree, as_dtype
from ..parameter import JAX_NAMES

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU", "gelu", "MaskSource"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``LeakyReLU(act_type="gelu")`` computes it."""
    return F.gelu(x, approximate="none")


class GELU(HybridBlock):
    def forward(self, x):
        return gelu(x)

    def _trace(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class _SequentialMixin:
    def add(self, *blocks: nn.Module) -> None:
        for block in blocks:
            self.append(block)

    def _trace(self, F, x):
        for block in self:
            x = block(x)
        return x


class Sequential(_SequentialMixin, Block, nn.Sequential):
    """Children run in order; named ``0, 1, ...`` as in the JAX
    package."""

    def __init__(self, *blocks: nn.Module, prefix=None, params=None):
        super().__init__(*blocks, prefix=prefix, params=params)


class HybridSequential(_SequentialMixin, HybridBlock, nn.Sequential):
    """Children run in order; named ``0, 1, ...`` as in the JAX
    package."""

    def __init__(self, *blocks: nn.Module, prefix=None, params=None):
        super().__init__(*blocks, prefix=prefix, params=params)


class Activation(HybridBlock):
    """``Activation(act_type)``: relu, sigmoid, tanh, softrelu, softsign."""

    def __init__(self, activation: str, prefix=None, params=None):
        nn_ops.check_act_type(activation)
        self._act_type = activation  # the naming hint (_alias) reads it
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return nn_ops.activation(x, self._act_type)

    def _trace(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Dense(HybridBlock):
    """``FullyConnected``: ``x . W^T + b``, then ``activation`` if given.
    With ``flatten`` (the default, as in the JAX package) an input of more
    than two axes is first collapsed to ``(N, in_units)``; without it the
    product runs over the last axis. ``in_units=0`` resolves at the first
    forward."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 flatten: bool = True, dtype=torch.float32,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units: int = 0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self.weight = self._new_param("weight", (units, in_units), dtype,
                                      weight_initializer, device)
        self.bias = self._new_param("bias", (units,), dtype,
                                    bias_initializer, device) \
            if use_bias else None
        with self.name_scope():
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        in_units = x.shape[-1] if not self._flatten \
            else math.prod(x.shape[1:])
        self.param("weight").shape = (self._units, in_units)

    def forward(self, x):
        out = nn_ops.fully_connected(x, self.weight, self.bias,
                                     flatten=self._flatten)
        return out if self.act is None else self.act(out)

    def _trace(self, F, x):
        v = self._param_vars()
        if self.bias is None:
            out = F.FullyConnected(x, v["weight"], num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, v["weight"], v["bias"],
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        shape = self.param("weight").shape
        return f"{shape[1] or None} -> {shape[0]}, flatten={self._flatten}"


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return nn_ops.flatten(x)

    def _trace(self, F, x):
        return F.Flatten(x)


class MaskSource:
    """A block's own ``torch.Generator`` for its random masks (Dropout's,
    a recurrent layer's between its layers, the random cells'), seeded
    from torch's global generator when the block is made (so
    ``torch.manual_seed`` fixes them) and made on the device of the first
    tensor it serves, or on ``device`` where given; :meth:`manual_seed`
    restarts it, so that two runs draw the same masks. The fused step
    finds it through :meth:`_generator`."""

    def _init_masks(self, device=None):
        self._gen = None
        self.manual_seed(int(torch.randint(0, 2 ** 62, ()).item()))
        if device is not None:
            self._generator(resolve_device(device))

    def manual_seed(self, seed: int) -> None:
        self._seed = seed
        if self._gen is not None:
            self._gen.manual_seed(seed)

    def _generator(self, device) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self._seed)
        return self._gen

    def _keep(self, p, shape, device) -> torch.Tensor:
        """A boolean mask of ``shape`` on ``device``, True with
        probability ``1 - p``."""
        gen = self._generator(device)
        if gen.device != device:
            raise MXNetError(f"{type(self).__name__}: input on {device}, "
                             f"the block's generator on {gen.device}")
        return torch.rand(shape, generator=gen, device=device) >= p


class Dropout(HybridBlock, MaskSource):
    """Dropout with rate ``rate``, active exactly when
    ``autograd.is_training()`` (inside ``autograd.record()``), as the JAX
    package's ``F.Dropout`` is; elsewhere, serving included, the identity.
    ``axes`` share one mask along those axes (the JAX package's variational
    dropout).

    Kept elements are scaled by ``1 / (1 - rate)``. Masks come from the
    layer's own generator (:class:`MaskSource`)."""

    def __init__(self, rate: float = 0.0, axes=(), prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate
        self._axes = tuple(axes)
        self._init_masks(device)

    def forward(self, x):
        if self.rate == 0.0 or not autograd.is_training():
            return x
        shape = [1 if i in self._axes else s for i, s in enumerate(x.shape)]
        keep = self._keep(self.rate, shape, x.device)
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.rate))

    def _trace(self, F, x):
        if self.rate > 0:
            return F.Dropout(x, p=self.rate, axes=self._axes)
        return F.identity(x)

    def extra_repr(self):
        return f"rate={self.rate}"


class _Norm(HybridBlock):
    """A normalization layer's ``gamma``/``beta`` (``weight``/``bias``),
    trained unless ``scale``/``center`` is off, over ``in_channels``
    (0: resolved at the first forward from axis ``_axis``)."""

    _JAX_NAMES = JAX_NAMES

    def _norm_params(self, in_channels, center, scale, beta_initializer,
                     gamma_initializer, device, dtype):
        shape = (in_channels,)
        self.weight = self._new_param("weight", shape, dtype,
                                      gamma_initializer, device,
                                      "write" if scale else "null")
        self.bias = self._new_param("bias", shape, dtype, beta_initializer,
                                    device, "write" if center else "null")

    def _infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        for attr, _ in self.named_parameters(recurse=False):
            self.param(attr).shape = (c,)

    def extra_repr(self):
        return f"axis={self._axis}, " \
               f"in_channels={self.param('weight').shape[0] or None}"


class BatchNorm(_Norm):
    """Batch normalization over every axis but ``axis``
    (:func:`~mxnet_tpu_torch.ops.nn.batch_norm`, with ``eps=epsilon`` and
    ``fix_gamma = not scale``). In training (``autograd.is_training()``)
    it normalizes by the batch's statistics and writes the moved running
    statistics back; elsewhere, or with ``use_global_stats``, by the
    running ones. ``running_mean``/``running_var`` are parameters with
    ``grad_req="null"``, collected and carried by name and never updated
    by the Trainer. :meth:`cast` keeps them all fp32 for a 16-bit type, as
    mixed-precision training wants (before the shapes resolve too)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._kwargs = dict(eps=epsilon, momentum=momentum,
                            fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer, device, dtype)
        shape = (in_channels,)
        self.running_mean = self._new_param(
            "running_mean", shape, dtype, running_mean_initializer, device,
            "null", differentiable=False)
        self.running_var = self._new_param(
            "running_var", shape, dtype, running_variance_initializer,
            device, "null", differentiable=False)

    def cast(self, dtype):
        dtype = as_dtype(dtype)
        if dtype in (torch.float16, torch.bfloat16):
            dtype = torch.float32
        super().cast(dtype)

    def forward(self, x):
        out, new_mean, new_var = nn_ops.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            axis=self._axis, **self._kwargs)
        if new_mean is not self.running_mean:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return out

    def _trace(self, F, x):
        v = self._param_vars()
        return F.BatchNorm(x, v["weight"], v["bias"], v["running_mean"],
                           v["running_var"], axis=self._axis,
                           **self._kwargs)


class InstanceNorm(_Norm):
    """Normalization over the spatial axes of each (sample, channel),
    then ``gamma``/``beta`` per channel (``scale`` off by default, as in
    the JAX package)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer, device, dtype)

    def hybrid_forward(self, F, x, weight, bias):
        return F.InstanceNorm(x, weight, bias, eps=self._eps)


class LayerNorm(_Norm):
    """Normalization over axis ``axis`` (the last by default)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self.eps = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer, device, dtype)

    def forward(self, x):
        if self._axis in (-1, x.dim() - 1):
            return F.layer_norm(x, self.weight.shape, self.weight,
                                self.bias, self.eps)
        return nn_ops.layer_norm(x, self.weight, self.bias, axis=self._axis,
                                 eps=self.eps)

    def _trace(self, F, x):
        v = self._param_vars()
        return F.LayerNorm(x, v["weight"], v["bias"], axis=self._axis,
                           eps=self.eps)


class GroupNorm(_Norm):
    """Normalization over ``num_groups`` groups of channels (axis 1),
    ``gamma``/``beta`` per channel."""

    _axis = 1

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._eps = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer, device, dtype)

    def hybrid_forward(self, F, x, weight, bias):
        return F.GroupNorm(x, weight, bias, num_groups=self._num_groups,
                           eps=self._eps)


class Embedding(HybridBlock):
    """Row lookup into an ``(input_dim, output_dim)`` table; an index in
    ``[-n, -1]`` wraps and any other out-of-range index gives a NaN row,
    as in the JAX package (:func:`~mxnet_tpu_torch.ops.nn.embedding`).
    ``sparse_grad`` is passed on to the traced ``Embedding`` node; the
    weight's gradient is dense, as the JAX package's Gluon gives it (its
    parameters hold dense gradient buffers)."""

    def __init__(self, input_dim: int, output_dim: int, dtype=torch.float32,
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._sparse_grad = sparse_grad
        self._dims = (input_dim, output_dim)
        self.weight = self._new_param("weight", self._dims, dtype,
                                      weight_initializer, device)

    def forward(self, x):
        return nn_ops.embedding(x, self.weight)

    def _trace(self, F, x):
        return F.Embedding(x, self._param_vars()["weight"],
                           input_dim=self._dims[0],
                           output_dim=self._dims[1],
                           sparse_grad=self._sparse_grad)

    def extra_repr(self):
        return f"{self._dims[0]} -> {self._dims[1]}"


class Lambda(Block):
    """A block of a function on NDArrays, or of the name of an ``nd``
    function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_ns
            if not hasattr(nd_ns, function):
                raise MXNetError(f"Function name {function} is not found "
                                 "in ndarray")
            function = getattr(nd_ns, function)
        self._func_impl = function

    def forward(self, *args):
        return _unwrap_tree(self._func_impl(*[_wrap_tree(a) for a in args]))


class HybridLambda(HybridBlock):
    """A block of ``function(F, x, *args)``, or of the name of a function
    that ``F`` (``nd`` or ``sym``) has."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name, self._func = function, None
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "lambda")

    def hybrid_forward(self, F, x, *args):
        if self._func is not None:
            return self._func(F, x, *args)
        return getattr(F, self._func_name)(x, *args)


class LeakyReLU(HybridBlock):
    """``x`` where positive, else ``alpha * x``."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` per channel
    (``in_channels`` of them, one by default)."""

    def __init__(self, alpha_initializer=init_mod.Constant(0.25),
                 in_channels=1, prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self.alpha = self._new_param("alpha", (in_channels,), dtype,
                                     alpha_initializer, device,
                                     allow_deferred_init=False)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` where positive, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (Klambauer et al. 2017)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
