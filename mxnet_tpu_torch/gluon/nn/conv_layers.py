"""Convolution, transposed convolution, pooling and padding layers as
Gluon blocks.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``'s ``Conv1D``/
``Conv2D``/``Conv3D``, ``Conv1DTranspose``/``Conv2DTranspose``/
``Conv3DTranspose``, the max, average and global pools and
``ReflectionPad2D``, over :mod:`mxnet_tpu_torch.ops.nn` (cuDNN and ATen
on the card). Channels come first (NCW, NCHW, NCDHW); ``in_channels=0``
(the default) resolves at the first forward. A convolution's weight is
``(channels, in_channels / groups, *kernel)`` and a transposed one's
``(in_channels, channels / groups, *kernel)``, the layouts of both
packages, with a bias by default (``use_bias=True``).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import nn as nn_ops
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _Conv(HybridBlock):
    def __init__(self, n, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, device, dtype,
                 prefix=None, params=None, output_padding=None):
        super().__init__(prefix=prefix, params=params)
        if layout != _LAYOUTS[n]:
            raise NotImplementedError(
                f"layout {layout!r}: the port's convolutions take "
                f"{_LAYOUTS[n]}; the channels-last choice is held in ROADMAP "
                "Queue A until a benchmark measures it")
        self._transposed = output_padding is not None
        if in_channels % groups or channels % groups:
            raise MXNetError(f"{type(self).__name__}: {in_channels} -> "
                             f"{channels} channels in {groups} groups")
        self._channels = channels
        self._kwargs = dict(kernel=_tuple(kernel_size, n),
                            stride=_tuple(strides, n),
                            pad=_tuple(padding, n),
                            dilate=_tuple(dilation, n), num_group=groups)
        if self._transposed:
            self._kwargs["adj"] = _tuple(output_padding, n)
        self.weight = self._new_param(
            "weight", self._weight_shape(in_channels), dtype,
            weight_initializer, device)
        self.bias = self._new_param("bias", (channels,), dtype,
                                    bias_initializer, device) \
            if use_bias else None
        with self.name_scope():
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _weight_shape(self, in_channels):
        g = self._kwargs["num_group"]
        if self._transposed:
            return (in_channels, self._channels // g) + self._kwargs["kernel"]
        return (self._channels, in_channels // g) + self._kwargs["kernel"]

    def _infer_param_shapes(self, x, *args):
        self.param("weight").shape = self._weight_shape(x.shape[1])

    def forward(self, x):
        if self._transposed:
            out = nn_ops.deconvolution(
                x, self.weight, *(() if self.bias is None else (self.bias,)),
                no_bias=self.bias is None, **self._kwargs)
        else:
            out = nn_ops.convolution(x, self.weight, self.bias,
                                     **self._kwargs)
        return out if self.act is None else self.act(out)

    def _trace(self, F, x):
        v = self._param_vars()
        k = self._kwargs
        params = dict(kernel=k["kernel"], stride=k["stride"],
                      dilate=k["dilate"], pad=k["pad"],
                      num_filter=self._channels,
                      num_group=k["num_group"], no_bias=self.bias is None)
        if self._transposed:
            params["adj"] = k["adj"]
        ins = [x, v["weight"]] + ([] if self.bias is None else [v["bias"]])
        op = F.Deconvolution if self._transposed else F.Convolution
        out = op(*ins, **params)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        w = self.param("weight").shape
        cin = w[0] if self._transposed else w[1] * self._kwargs["num_group"]
        return (f"{cin or None} -> {self._channels}, "
                f"kernel={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"pad={self._kwargs['pad']}, bias={self.bias is not None}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 dtype=torch.float32, prefix=None, params=None):
        super().__init__(1, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 dtype=torch.float32, prefix=None, params=None):
        super().__init__(2, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, device=None, dtype=torch.float32,
                 prefix=None, params=None):
        super().__init__(3, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 dtype=torch.float32, prefix=None, params=None):
        super().__init__(1, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params, output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, device=None, dtype=torch.float32,
                 prefix=None, params=None):
        super().__init__(2, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params, output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 dtype=torch.float32, prefix=None, params=None):
        super().__init__(3, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, prefix, params, output_padding)


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


class ReflectionPad2D(HybridBlock):
    """Pad the two spatial axes of an NCHW input by reflection:
    ``padding`` on every side, or the ``Pad`` op's 8-tuple."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
