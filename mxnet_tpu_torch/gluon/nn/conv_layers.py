"""Convolution and pooling layers as Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``'s ``Conv1D``/
``Conv2D``/``Conv3D`` and the max, average and global pools, over
:mod:`mxnet_tpu_torch.ops.nn` (cuDNN and ATen on the card). Channels come
first (NCW, NCHW, NCDHW) and ``in_channels`` is required: the port builds
shapes up front. A convolution's weight is ``(channels, in_channels /
groups, *kernel)``, the layout of both packages, with a bias by default
(``use_bias=True``). The transposed convolutions and ``ReflectionPad2D``
are not ported yet.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as nn_ops
from ..block import HybridBlock, as_dtype
from ..parameter import make_param
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _Conv(HybridBlock):
    def __init__(self, n, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, device, dtype):
        super().__init__()
        if layout != _LAYOUTS[n]:
            raise NotImplementedError(
                f"layout {layout!r}: the port's convolutions take "
                f"{_LAYOUTS[n]}; the channels-last choice waits in ROADMAP "
                "Queue A item 2")
        if in_channels <= 0:
            raise MXNetError(f"{type(self).__name__}: in_channels is "
                             "required (the port builds shapes up front)")
        if in_channels % groups or channels % groups:
            raise MXNetError(f"{type(self).__name__}: {in_channels} -> "
                             f"{channels} channels in {groups} groups")
        dev = resolve_device(device)
        dtype = as_dtype(dtype)
        self._kwargs = dict(kernel=_tuple(kernel_size, n),
                            stride=_tuple(strides, n),
                            pad=_tuple(padding, n),
                            dilate=_tuple(dilation, n), num_group=groups)
        self.weight = make_param("weight", (channels, in_channels // groups)
                                 + self._kwargs["kernel"], dev, dtype,
                                 weight_initializer)
        self.bias = make_param("bias", (channels,), dev, dtype,
                               bias_initializer) if use_bias else None
        self.act = Activation(activation) if activation is not None \
            else None

    def forward(self, x):
        out = nn_ops.convolution(x, self.weight, self.bias, **self._kwargs)
        return out if self.act is None else self.act(out)

    def _trace(self, F, x):
        v = self._param_vars()
        k = self._kwargs
        params = dict(kernel=k["kernel"], stride=k["stride"],
                      dilate=k["dilate"], pad=k["pad"],
                      num_filter=self.weight.shape[0],
                      num_group=k["num_group"], no_bias=self.bias is None)
        ins = [x, v["weight"]] + ([] if self.bias is None else [v["bias"]])
        out = F.Convolution(*ins, **params)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        w = self.weight.shape
        return (f"{w[1] * self._kwargs['num_group']} -> {w[0]}, "
                f"kernel={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"pad={self._kwargs['pad']}, bias={self.bias is not None}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device="cuda",
                 dtype=torch.float32):
        super().__init__(1, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device="cuda",
                 dtype=torch.float32):
        super().__init__(2, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, device="cuda", dtype=torch.float32):
        super().__init__(3, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)


class _Pooling(HybridBlock):
    def __init__(self, n, pool_size, strides, padding, ceil_mode,
                 global_pool, pool_type, layout, count_include_pad=True):
        super().__init__()
        if layout != _LAYOUTS[n]:
            raise NotImplementedError(
                f"layout {layout!r}: the port's pools take {_LAYOUTS[n]}")
        pool_size = _tuple(pool_size, n)
        self._kwargs = dict(
            kernel=pool_size,
            stride=pool_size if strides is None else _tuple(strides, n),
            pad=_tuple(padding, n), global_pool=global_pool,
            pool_type=pool_type,
            pooling_convention="full" if ceil_mode else "valid",
            count_include_pad=count_include_pad)

    def _alias(self):
        return "pool"

    def forward(self, x):
        return nn_ops.pooling(x, **self._kwargs)

    def _trace(self, F, x):
        k = dict(self._kwargs)
        if k["pool_type"] == "max" or k["global_pool"]:
            k.pop("count_include_pad")  # the JAX layers leave it out
        return F.Pooling(x, **k)

    def extra_repr(self):
        if self._kwargs["global_pool"]:
            return "global"
        return (f"size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"pad={self._kwargs['pad']}, "
                f"{self._kwargs['pooling_convention']}")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(1, pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(2, pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(3, pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(1, pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(2, pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(3, pool_size, strides, padding, ceil_mode, False,
                         "avg", layout, count_include_pad)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, 1, None, 0, True, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__(2, 1, None, 0, True, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(3, 1, None, 0, True, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, 1, None, 0, True, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__(2, 1, None, 0, True, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(3, 1, None, 0, True, True, "avg", layout)
