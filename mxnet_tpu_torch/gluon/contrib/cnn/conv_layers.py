"""``DeformableConvolution``: a convolution that predicts its taps'
offsets, then samples the input there.

Counterpart of ``mxnet_tpu/gluon/contrib/cnn/conv_layers.py``. The
``offset`` child is a ``Conv2D`` (zero-initialized by default, so the
layer starts as a plain convolution) and the sampling and product are
the ``_contrib_DeformableConvolution`` op
(:func:`mxnet_tpu_torch.ops.extra_ops.deformable_convolution`).
"""
from __future__ import annotations

import torch

from ....ops import nn as nn_ops
from ....ops.extra_ops import deformable_convolution
from ...block import HybridBlock
from ...nn import Conv2D

__all__ = ["DeformableConvolution"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    """2-D deformable convolution (Dai et al. 2017) of ``channels``
    filters; ``in_channels=0`` resolves at the first forward."""

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._stride = _pair(strides)
        self._pad = _pair(padding)
        self._dilate = _pair(dilation)
        self._groups = groups
        self._ndg = num_deformable_group
        self._activation = activation
        kh, kw = self._kernel
        with self.name_scope():
            self.offset = Conv2D(
                2 * num_deformable_group * kh * kw, self._kernel,
                strides=self._stride, padding=self._pad,
                dilation=self._dilate, use_bias=offset_use_bias,
                weight_initializer=offset_weight_initializer,
                bias_initializer=offset_bias_initializer, prefix="offset_",
                device=device)
        self.weight = self._new_param(
            "weight", (channels, in_channels // groups, kh, kw), dtype,
            weight_initializer, device)
        self.bias = self._new_param("bias", (channels,), dtype,
                                    bias_initializer, device) \
            if use_bias else None

    def _infer_param_shapes(self, x, *args):
        kh, kw = self._kernel
        self.param("weight").shape = (self._channels,
                                      x.shape[1] // self._groups, kh, kw)

    def forward(self, x):
        offset = self.offset(x)
        args = [x, offset, self.weight] + \
            ([self.bias] if self.bias is not None else [])
        out = deformable_convolution(
            *args, kernel=self._kernel, stride=self._stride, pad=self._pad,
            dilate=self._dilate, num_filter=self._channels,
            num_group=self._groups, num_deformable_group=self._ndg,
            no_bias=self.bias is None)
        if self._activation:
            out = nn_ops.activation(out, self._activation)
        return out
