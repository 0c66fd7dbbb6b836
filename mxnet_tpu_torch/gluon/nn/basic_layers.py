"""Basic layers as Gluon blocks: the subsets BERT and ResNet need.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``. Shapes are given
up front (no deferred initialization: ``Dense`` takes ``in_units``,
``BatchNorm`` ``in_channels``) and every layer with parameters takes
``device=`` (default ``"cuda"``, raising without a GPU) and ``dtype=``.
A layer holds usable values from construction (a weight U(-0.07, 0.07),
the JAX package's default initializer, from torch's global generator;
biases, gammas and running statistics from their own initializers) until
``Block.initialize`` sets them. Parameter layouts match the JAX package,
so weights carry over one to one (``convert.py``): a ``Dense`` weight is
``(units, in_units)``, the layout of ``torch.nn.Linear``; a LayerNorm's
or BatchNorm's ``gamma``/``beta`` are ``weight``/``bias`` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import autograd
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as nn_ops
from ..block import HybridBlock, as_dtype
from ..parameter import JAX_NAMES, make_param

__all__ = ["HybridSequential", "Dense", "Activation", "Dropout", "BatchNorm",
           "LayerNorm", "Embedding", "Flatten", "GELU", "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``LeakyReLU(act_type="gelu")`` computes it."""
    return F.gelu(x, approximate="none")


class GELU(HybridBlock):
    def forward(self, x):
        return gelu(x)

    def _trace(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class HybridSequential(HybridBlock, nn.Sequential):
    """Children run in order; named ``0, 1, ...`` as in the JAX package."""

    def __init__(self, *blocks: nn.Module, prefix=None):
        super().__init__(*blocks, prefix=prefix)

    def add(self, *blocks: nn.Module) -> None:
        for block in blocks:
            self.append(block)

    def _trace(self, F, x):
        for block in self:
            x = block(x)
        return x


class Activation(HybridBlock):
    """``Activation(act_type)``: relu, sigmoid, tanh, softrelu, softsign."""

    def __init__(self, activation: str):
        nn_ops.check_act_type(activation)
        self._act_type = activation  # the naming hint (_alias) reads it
        super().__init__()

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
    product runs over the last axis."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 flatten: bool = True, activation=None,
                 weight_initializer=None, bias_initializer="zeros",
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense: in_units is required (the port builds "
                             "shapes up front)")
        dev = resolve_device(device)
        dtype = as_dtype(dtype)
        self._flatten = flatten
        self.weight = make_param("weight", (units, in_units), dev, dtype,
                                 weight_initializer)
        self.bias = make_param("bias", (units,), dev, dtype,
                               bias_initializer) if use_bias else None
        self.act = Activation(activation) if activation is not None \
            else None

    def forward(self, x):
        out = nn_ops.fully_connected(x, self.weight, self.bias,
                                     flatten=self._flatten)
        return out if self.act is None else self.act(out)

    def _trace(self, F, x):
        v = self._param_vars()
        units = self.weight.shape[0]
        if self.bias is None:
            out = F.FullyConnected(x, v["weight"], num_hidden=units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, v["weight"], v["bias"],
                                   num_hidden=units, flatten=self._flatten)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        return (f"{self.weight.shape[1]} -> {self.weight.shape[0]}, "
                f"flatten={self._flatten}")


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return nn_ops.flatten(x)

    def _trace(self, F, x):
        return F.Flatten(x)


class Dropout(HybridBlock):
    """Dropout with rate ``rate``, active exactly when
    ``autograd.is_training()`` (inside ``autograd.record()``), as the JAX
    package's ``F.Dropout`` is; elsewhere, serving included, the identity.

    Kept elements are scaled by ``1 / (1 - rate)``. Masks come from the
    layer's own ``torch.Generator`` on its device, seeded from torch's
    global generator (so ``torch.manual_seed`` fixes them);
    :meth:`manual_seed` restarts it, so that two runs draw the same
    masks."""

    def __init__(self, rate: float = 0.0, device="cuda"):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate
        self._gen = torch.Generator(device=resolve_device(device))
        self.manual_seed(int(torch.randint(0, 2 ** 62, ()).item()))

    def manual_seed(self, seed: int) -> None:
        self._gen.manual_seed(seed)

    def forward(self, x):
        if self.rate == 0.0 or not autograd.is_training():
            return x
        if x.device != self._gen.device:
            raise MXNetError(f"Dropout: input on {x.device}, the layer's "
                             f"generator on {self._gen.device}")
        keep = torch.rand(x.shape, generator=self._gen, device=x.device) \
            >= self.rate
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.rate))

    def _trace(self, F, x):
        if self.rate > 0:
            return F.Dropout(x, p=self.rate, axes=())
        return F.identity(x)

    def extra_repr(self):
        return f"rate={self.rate}"


class BatchNorm(HybridBlock):
    """Batch normalization over every axis but ``axis``
    (:func:`~mxnet_tpu_torch.ops.nn.batch_norm`, with ``eps=epsilon`` and
    ``fix_gamma = not scale``). In training (``autograd.is_training()``)
    it normalizes by the batch's statistics and writes the moved running
    statistics back; elsewhere, or with ``use_global_stats``, by the
    running ones. ``gamma``/``beta`` are ``weight``/``bias``, trained
    unless ``scale``/``center`` is off; ``running_mean``/``running_var``
    are parameters with ``requires_grad=False`` (the JAX package's
    ``grad_req="null"``), collected and carried by name and never updated
    by the Trainer. :meth:`cast` keeps them all fp32 for a 16-bit type, as
    mixed-precision training wants."""

    _JAX_NAMES = JAX_NAMES

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm: in_channels is required (the port "
                             "builds shapes up front)")
        dev = resolve_device(device)
        dtype = as_dtype(dtype)
        self._axis = axis
        self._kwargs = dict(eps=epsilon, momentum=momentum,
                            fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        shape = (in_channels,)
        self.weight = make_param("gamma", shape, dev, dtype,
                                 gamma_initializer, scale)
        self.bias = make_param("beta", shape, dev, dtype, beta_initializer,
                               center)
        self.running_mean = make_param("running_mean", shape, dev, dtype,
                                       running_mean_initializer, False)
        self.running_var = make_param("running_var", shape, dev, dtype,
                                      running_variance_initializer, False)

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

    def extra_repr(self):
        return f"axis={self._axis}, in_channels={self.weight.shape[0]}"


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis, eps 1e-5."""

    _JAX_NAMES = JAX_NAMES

    def __init__(self, in_channels: int, epsilon: float = 1e-5,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps = epsilon
        self.weight = make_param("gamma", (in_channels,), dev, dtype, "ones")
        self.bias = make_param("beta", (in_channels,), dev, dtype, "zeros")

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias,
                            self.eps)

    def _trace(self, F, x):
        v = self._param_vars()
        return F.LayerNorm(x, v["weight"], v["bias"], axis=-1, eps=self.eps)


class Embedding(HybridBlock):
    """Row lookup into an ``(input_dim, output_dim)`` table; an index in
    ``[-n, -1]`` wraps and any other out-of-range index gives a NaN row,
    as in the JAX package (:func:`~mxnet_tpu_torch.ops.nn.embedding`).
    ``sparse_grad`` is passed on to the traced ``Embedding`` node; the
    weight's gradient is dense, as the JAX package's Gluon gives it (its
    parameters hold dense gradient buffers)."""

    def __init__(self, input_dim: int, output_dim: int, device="cuda",
                 dtype=torch.float32, sparse_grad=False):
        super().__init__()
        self._sparse_grad = sparse_grad
        self.weight = make_param("weight", (input_dim, output_dim),
                                 resolve_device(device), dtype)

    def forward(self, x):
        return nn_ops.embedding(x, self.weight)

    def _trace(self, F, x):
        return F.Embedding(x, self._param_vars()["weight"],
                           input_dim=self.weight.shape[0],
                           output_dim=self.weight.shape[1],
                           sparse_grad=self._sparse_grad)

    def extra_repr(self):
        return f"{self.weight.shape[0]} -> {self.weight.shape[1]}"
