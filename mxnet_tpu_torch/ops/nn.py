"""Neural-net layer ops as plain functions on tensors: the ResNet subset.

Counterpart of ``mxnet_tpu/ops/nn.py``'s ``convolution``, ``pooling``,
``activation``, ``fully_connected`` and ``batch_norm``, and of ``Flatten``
(``mxnet_tpu/ops/tensor.py``). None of them is a hand-written kernel in
either package: the JAX package lowers them to XLA, the port to cuDNN and
ATen, with the reference's conventions computed where torch's own differ:

- ``pooling``: the ``full`` convention pads the right edge by what the
  last window needs and, with ``count_include_pad``, an average divides by
  ``prod(kernel)`` even over that extra pad (torch's ``ceil_mode`` drops a
  window that starts in the padding and clips the divisor);
- ``batch_norm``: the moving statistics take the **biased** batch variance,
  ``new = momentum * old + (1 - momentum) * batch`` (torch's running
  buffers take the unbiased one and ``momentum`` as ``1 - m``); 16-bit
  inputs keep their statistics in fp32 and come out in their own dtype.

Layouts are channels-first (NCW, NCHW, NCDHW); tensors run in the memory
format they are given. The JAX package's per-shape NCHW/NHWC choice on an
accelerator (``operator_tune``) waits in ROADMAP Queue A item 3.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import autograd
from ..base import MXNetError

__all__ = ["convolution", "pooling", "activation", "fully_connected",
           "flatten", "batch_norm"]


def _tuple(v, n: int) -> Tuple[int, ...]:
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return None
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * n


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_group=1, no_bias=False):
    """N-D convolution, ``data`` (N, C, *spatial) and ``weight``
    (O, C / num_group, *kernel), with ``stride``, symmetric ``pad``,
    ``dilate`` and ``num_group`` groups; ``bias`` (O,) is added unless
    ``no_bias``."""
    k = data.dim() - 2
    if k not in _CONV:
        raise MXNetError(f"convolution: {data.dim()}-D input; 3-D to 5-D "
                         "(NCW, NCHW, NCDHW) supported")
    if kernel is not None and tuple(kernel) != tuple(weight.shape[2:]):
        raise MXNetError(f"convolution: kernel {tuple(kernel)} != weight "
                         f"{tuple(weight.shape)}")
    return _CONV[k](data, weight, None if no_bias else bias,
                    stride=_tuple(stride, k) or 1,
                    padding=_tuple(pad, k) or 0,
                    dilation=_tuple(dilate, k) or 1, groups=num_group)


def flatten(data):
    """Collapse every axis but the first: (N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def fully_connected(data, weight, bias=None, no_bias=False, flatten=True):
    """``data . weight^T (+ bias)``; ``flatten`` first collapses the axes
    after the first, else the product runs over the last axis."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh, "softrelu": F.softplus,
               "softsign": F.softsign}


def check_act_type(act_type: str) -> None:
    if act_type not in ACTIVATIONS:
        raise MXNetError(f"unknown act_type {act_type!r} (known: "
                         f"{sorted(ACTIVATIONS)})")


def activation(data, act_type="relu"):
    """Elementwise relu, sigmoid, tanh, softrelu (softplus) or
    softsign."""
    check_act_type(act_type)
    return ACTIVATIONS[act_type](data)


# -- pooling -------------------------------------------------------------

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, kernel, stride):
    """Window sums over unpadded ``x`` (1-D pools run as 2-D with a unit
    axis: ``avg_pool1d`` has no ``divisor_override``)."""
    if len(kernel) == 1:
        return _sum_pool(x.unsqueeze(-1), kernel + (1,),
                         stride + (1,)).squeeze(-1)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, 0, divisor_override=1)


def _pad(x, pads: Sequence[Tuple[int, int]], value=0.0):
    """Pad the spatial axes by ``(left, right)`` each."""
    flat = []
    for left, right in reversed(pads):
        flat += [left, right]
    return F.pad(x, flat, value=value) if any(flat) else x


def pooling(data, kernel=(2, 2), pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True):
    """max / avg / sum pooling over the spatial axes of (N, C, ...).

    ``valid`` keeps the windows that fit inside the padded input; ``full``
    pads the right edge so that ``ceil((size - kernel) / stride) + 1``
    windows fit (size includes both pads), as the reference does. A max
    treats padding as -inf; an average with ``count_include_pad`` divides
    by ``prod(kernel)``, without it by the window's count of input
    elements; ``global_pool`` reduces every spatial axis."""
    k = data.dim() - 2
    if k not in (1, 2, 3):
        raise MXNetError(f"pooling: {data.dim()}-D input; 3-D to 5-D "
                         "supported")
    spatial = tuple(range(2, data.dim()))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        raise MXNetError(f"unknown pool_type {pool_type!r}")
    kernel = _tuple(kernel, k)
    stride = _tuple(stride, k) or (1,) * k
    pad = _tuple(pad, k) or (0,) * k
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"unknown pooling_convention "
                         f"{pooling_convention!r}")
    pads = []
    for i in range(k):
        extra = 0
        if pooling_convention == "full":
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-max(size - kernel[i], 0) // stride[i]) + 1
            extra = max((out - 1) * stride[i] + kernel[i] - size, 0)
        pads.append((pad[i], pad[i] + extra))
    # torch pads implicitly (symmetric, at most half the window): the
    # reference's own rule then, with no extra copy of the input
    native = all(left == right and 2 * left <= kk
                 for (left, right), kk in zip(pads, kernel))
    if pool_type == "max":
        if native:
            return _MAX[k](data, kernel, stride, pad)
        return _MAX[k](_pad(data, pads, float("-inf")), kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise MXNetError(f"unknown pool_type {pool_type!r}")
    if pool_type == "avg" and native and k > 1:
        pool = F.avg_pool2d if k == 2 else F.avg_pool3d
        return pool(data, kernel, stride, pad,
                    count_include_pad=count_include_pad)
    s = _sum_pool(_pad(data, pads), kernel, stride)
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / math.prod(kernel)
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return s / _sum_pool(_pad(ones, pads), kernel, stride)


# -- batch normalization ---------------------------------------------------

def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training: Optional[bool] = None):
    """Batch normalization over every axis but ``axis``; returns ``(out,
    new_moving_mean, new_moving_var)`` and leaves the moving statistics
    alone (the caller writes them back).

    In training (``autograd.is_training()`` unless ``training`` is given)
    and without ``use_global_stats`` it normalizes by the batch's mean and
    biased variance and moves the statistics by
    ``momentum * old + (1 - momentum) * batch``; otherwise it normalizes by
    the moving statistics, which come back unchanged. ``fix_gamma`` scales
    by ones. A 16-bit input is normalized with fp32 statistics and comes
    out in its own dtype."""
    if training is None:
        training = autograd.is_training()
    axis = axis % data.dim()
    if axis != 1:
        out, m, v = batch_norm(data.movedim(axis, 1), gamma, beta,
                               moving_mean, moving_var, eps, momentum,
                               fix_gamma, use_global_stats, 1, training)
        return out.movedim(1, axis), m, v
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if not training or use_global_stats:
        out = F.batch_norm(data, moving_mean, moving_var, g, beta,
                           training=False, eps=eps)
        return out, moving_mean, moving_var
    n = data.numel() // data.shape[1]
    if n < 2:
        raise MXNetError("batch_norm: training needs more than one value "
                         "per channel")
    # the batch statistics land in two scratch buffers (momentum 1: the
    # running update keeps the batch's values alone), so the statistics
    # come out of the same pass that normalizes
    stat = moving_mean.dtype
    batch_mean = torch.zeros(data.shape[1], dtype=stat, device=data.device)
    batch_var = torch.zeros_like(batch_mean)
    out = F.batch_norm(data, batch_mean, batch_var, g, beta, training=True,
                       momentum=1.0, eps=eps)
    with torch.no_grad():
        # the buffer holds the unbiased variance: back to the biased one
        biased = batch_var * ((n - 1) / n)
        new_mean = moving_mean * momentum + batch_mean * (1 - momentum)
        new_var = moving_var * momentum + biased * (1 - momentum)
    return out, new_mean, new_var
