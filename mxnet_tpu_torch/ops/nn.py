"""Neural-net layer ops as plain functions on tensors.

Counterpart of ``mxnet_tpu/ops/nn.py``. None of them is a hand-written
kernel in either package: the JAX package lowers them to XLA, the port to
cuDNN and ATen, with the reference's conventions computed where torch's
own differ:

- ``pooling``: the ``full`` convention pads the right edge by what the
  last window needs and, with ``count_include_pad``, an average divides by
  ``prod(kernel)`` even over that extra pad (torch's ``ceil_mode`` drops a
  window that starts in the padding and clips the divisor);
- ``batch_norm``: the moving statistics take the **biased** batch variance,
  ``new = momentum * old + (1 - momentum) * batch`` (torch's running
  buffers take the unbiased one and ``momentum`` as ``1 - m``); 16-bit
  inputs keep their statistics in fp32 and come out in their own dtype;
- ``embedding``: out-of-range rows as the JAX package gives them (an index
  in ``[-n, -1]`` wraps, any other gives a NaN row;
  :func:`~mxnet_tpu_torch.ops.tensor.take_fill`);
- the resizes (``_contrib_BilinearResize2D``, the non-divisible
  ``_contrib_AdaptiveAvgPooling2D``) are ``jax.image.resize``'s linear
  method: half-pixel centres, and a triangle filter widened by the scale
  when shrinking (torch's ``antialias=True``).

The functions the layers call take torch's calling convention
(``convolution``, ``pooling``, ``activation``, ``fully_connected``,
``flatten``, ``batch_norm``, ``embedding``); every op is also registered
under its MXNet name and signature for ``mx.nd``. ``SoftmaxOutput``, the
regression outputs and ``SVMOutput`` are loss layers whose backward
ignores the head gradient (``torch.autograd.Function``s). The spatial
transformer, ROI, ``im2col`` and ``Correlation`` ops are registered stubs
that raise ``NotImplementedError`` (the deferred half of ROADMAP Queue A
item 1).

Layouts are channels-first (NCW, NCHW, NCDHW); tensors run in the memory
format they are given. The JAX package's per-shape NCHW/NHWC choice on an
accelerator (``operator_tune``) is held in ROADMAP Queue A's list of
work held until a benchmark measures it (``channels_last``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import autograd
from ..base import MXNetError
from .registry import register_op, stub_op
from .tensor import _safe_acc, pick, take_fill

__all__ = ["convolution", "pooling", "activation", "fully_connected",
           "flatten", "batch_norm", "embedding", "pad_op", "softmax",
           "log_softmax"]


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


# -- embedding ---------------------------------------------------------------

def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data`` (any numeric dtype,
    truncated): an index in ``[-n, -1]`` wraps and any other index
    outside ``[0, n)`` gives a NaN row, as in the JAX package."""
    return take_fill(weight, data, 0)


# -- pad ----------------------------------------------------------------------

_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


def pad_op(data, mode="constant", pad_width=None, constant_value=0):
    """Pad by ``pad_width`` = (before, after) per axis, first axis first,
    with a constant, the edge value or the reflection."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(data.dim())]
    if mode not in _PAD_MODES:
        raise MXNetError(f"unknown pad mode {mode!r}")
    if mode == "constant":
        return F.pad(data, [x for lr in reversed(pw) for x in lr],
                     value=constant_value)
    if any(pw[0] + pw[1]):
        raise MXNetError("pad: edge and reflect pad the spatial axes only")
    return F.pad(data, [x for lr in reversed(pw[2:]) for x in lr],
                 mode=_PAD_MODES[mode])


# -- the ops under their MXNet names and signatures ---------------------------



@register_op("FullyConnected", input_names=("data", "weight", "bias"))
def _fully_connected_op(data, weight, *bias, num_hidden=0, no_bias=False,
                        flatten=True):
    """``data . weight^T (+ bias)``, the axes after the first collapsed
    unless ``flatten=False``."""
    return fully_connected(data, weight, bias[0] if bias else None,
                           no_bias or not bias, flatten)


@register_op("Convolution", aliases=["Convolution_v1"],
             input_names=("data", "weight", "bias"))
def _convolution_op(data, weight, *bias, kernel=None, stride=None,
                    dilate=None, pad=None, num_filter=0, num_group=1,
                    workspace=1024, no_bias=False, cudnn_tune=None,
                    cudnn_off=False, layout=None):
    """N-D convolution, channels first (:func:`convolution`)."""
    return convolution(data, weight, bias[0] if bias else None, kernel,
                       stride, dilate, pad, num_group, no_bias or not bias)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("Deconvolution", input_names=("data", "weight", "bias"))
def deconvolution(data, weight, *bias, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=0, num_group=1, workspace=512, no_bias=True,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution; ``weight`` is (in_channels, out_channels /
    num_group, *kernel). ``target_shape`` is ignored, as in the JAX
    package."""
    k = data.dim() - 2
    return _CONV_T[k](data, weight,
                      None if no_bias or not bias else bias[0],
                      stride=_tuple(stride, k) or 1,
                      padding=_tuple(pad, k) or 0,
                      output_padding=_tuple(adj, k) or 0, groups=num_group,
                      dilation=_tuple(dilate, k) or 1)


@register_op("Pooling", aliases=["Pooling_v1"])
def _pooling_op(data, kernel=(2, 2), pool_type="max", global_pool=False,
                cudnn_off=False, pooling_convention="valid", stride=None,
                pad=None, p_value=2, count_include_pad=True, layout=None):
    """max / avg / sum / lp pooling (:func:`pooling`)."""
    if pool_type == "lp":
        x = torch.abs(data) ** p_value
        s = pooling(x, kernel, "sum", global_pool, pooling_convention,
                    stride, pad)
        return s ** (1.0 / p_value)
    return pooling(data, kernel, pool_type, global_pool, pooling_convention,
                   stride, pad, count_include_pad)


def _resize(data, h, w):
    return F.interpolate(data, size=(int(h), int(w)), mode="bilinear",
                         align_corners=False, antialias=True)


@register_op("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pool2d(data, output_size=None):
    """Average over equal windows where the size divides, else the
    linear resize (as the JAX package)."""
    oh, ow = (1, 1) if not output_size else (
        tuple(output_size) if isinstance(output_size, (tuple, list))
        else (output_size, output_size))
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean((3, 5))
    return _resize(data, oh, ow)


@register_op("UpSampling")
def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest (repeat) or bilinear upsampling of the first input by
    ``scale``."""
    data = args[0]
    if sample_type == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return _resize(data, data.shape[2] * scale, data.shape[3] * scale)


@register_op("_contrib_BilinearResize2D")
def bilinear_resize2d(data, height=1, width=1, scale_height=None,
                      scale_width=None, mode="size"):
    """Linear resize to (height, width), or by the scale factors."""
    h, w = data.shape[2:]
    if scale_height is not None:
        height = int(round(h * scale_height))
        width = int(round(w * scale_width))
    return _resize(data, height, width)


register_op("Activation")(lambda data, act_type="relu":
                          activation(data, act_type))


@register_op("LeakyReLU", needs_rng=True)
def leaky_relu(data, *gamma, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, _training=False,
               _generator=None):
    """leaky / prelu (slope ``gamma`` per channel) / elu / selu / gelu
    (exact) / rrelu (a random slope in [lower, upper] in training, their
    mean otherwise)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma[0]
        if g.dim() < data.dim():
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        if _training and _generator is not None:
            u = torch.empty_like(data).uniform_(lower_bound, upper_bound,
                                                generator=_generator)
            return torch.where(data > 0, data, u * data)
        return torch.where(data > 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise MXNetError(f"unknown act_type {act_type!r}")


@register_op("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    """``clip(alpha * x + beta, 0, 1)``."""
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


# -- the softmax family -------------------------------------------------------

@register_op("softmax")
def softmax(data, *length, axis=-1, temperature=None, dtype=None,
            use_length=False):
    """Softmax along ``axis``, with ``temperature`` and, with
    ``use_length``, each row masked past its length."""
    data, restore = _safe_acc(data)
    x = data / temperature if temperature else data
    if use_length and length:
        ln = length[0].to(torch.int64)
        shp = [1] * x.dim()
        shp[axis] = -1
        pos = torch.arange(x.shape[axis], device=x.device).reshape(shp)
        mask = pos < ln.reshape(tuple(ln.shape) + (1,) * (x.dim()
                                                         - ln.dim()))
        x = x.masked_fill(~mask, float("-inf"))
        out = torch.softmax(x, axis).masked_fill(~mask, 0.0)
    else:
        out = torch.softmax(x, axis)
    return out.to(restore) if restore is not None else out


@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None,
                use_length=False):
    """``log(softmax)`` along ``axis``."""
    data, restore = _safe_acc(data)
    x = data / temperature if temperature else data
    out = torch.log_softmax(x, axis)
    return out.to(restore) if restore is not None else out


@register_op("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    """Softmax of ``-data``."""
    return torch.softmax(-data / (temperature or 1.0), axis)


@register_op("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """Softmax over each instance (flattened) or over the channels."""
    if mode == "channel":
        return torch.softmax(data, 1)
    return torch.softmax(data.reshape(data.shape[0], -1), -1).reshape(
        data.shape)


def _loss_grad(prob_rows, lab, grad_scale, ignore_label, use_ignore,
               normalization, smooth_alpha, nclass, batch):
    """``(prob - onehot(label)) * scale`` for rows of class scores."""
    oh = F.one_hot(lab.clamp(0, nclass - 1), nclass).to(prob_rows.dtype) \
        * ((lab >= 0) & (lab < nclass)).unsqueeze(-1).to(prob_rows.dtype)
    grad = prob_rows - oh
    if smooth_alpha:
        grad = grad + smooth_alpha * (1.0 / nclass - oh)
    denom = 1.0
    if use_ignore:
        keep = lab != int(ignore_label)
        grad = grad * keep.unsqueeze(-1).to(grad.dtype)
        if normalization == "valid":
            denom = keep.sum().clamp(min=1).to(grad.dtype)
    if normalization == "batch":
        denom = batch
    return grad * (grad_scale / denom)


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, params):
        multi = params[3]
        prob = torch.softmax(data, 1) if multi else torch.softmax(
            data.reshape(data.shape[0], -1), -1).reshape(data.shape)
        ctx.save_for_backward(prob, label)
        ctx.params = params
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi, norm, alpha = ctx.params
        lab = label.to(torch.int64)
        if multi:
            rows = prob.movedim(1, -1)
            grad = _loss_grad(rows, lab, grad_scale, ignore_label,
                              use_ignore, norm, alpha, rows.shape[-1],
                              prob.shape[0]).movedim(-1, 1)
        else:
            flat = prob.reshape(prob.shape[0], -1)
            grad = _loss_grad(flat, lab.reshape(-1), grad_scale,
                              ignore_label, use_ignore, norm, alpha,
                              flat.shape[-1], prob.shape[0]
                              ).reshape(prob.shape)
        return grad, None, None


@register_op("SoftmaxOutput", aliases=["Softmax"],
             input_names=("data", "label"))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """The softmax, as a loss layer: its backward is the cross-entropy
    gradient with respect to the logits, ``(prob - onehot(label)) *
    grad_scale``, whatever the head gradient."""
    return _SoftmaxOutputFn.apply(
        data, label, (grad_scale, ignore_label, use_ignore, multi_output,
                      normalization, smooth_alpha))


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed cross-entropy of logits against integer labels."""
    return -torch.sum(pick(torch.log_softmax(data, -1), label, axis=-1))


class _RegressionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, link, grad_fn, grad_scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        n = out.shape[0]
        scale = ctx.grad_scale / max(out.numel() // n, 1)
        return ctx.grad_fn(out, label) * scale, None, None, None, None


def _make_regression(link, grad_fn, name):
    @register_op(name, input_names=("data", "label"),
                 doc=f"{name}: a loss layer; forward applies the link "
                     f"function, backward is the regression gradient "
                     f"scaled by grad_scale / (values per sample), "
                     f"whatever the head gradient.")
    def reg(data, label, grad_scale=1.0):
        return _RegressionFn.apply(data, label.reshape(data.shape), link,
                                   grad_fn, grad_scale)
    return reg


_make_regression(lambda x: x, lambda o, lab: o - lab,
                 "LinearRegressionOutput")
_make_regression(torch.sigmoid, lambda o, lab: o - lab,
                 "LogisticRegressionOutput")
_make_regression(lambda x: x, lambda o, lab: torch.sign(o - lab),
                 "MAERegressionOutput")


class _SVMOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.params = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.params
        onehot = F.one_hot(label.to(torch.int64), out.shape[-1]).to(out.dtype)
        if use_linear:
            g_true = -(margin > out).to(out.dtype) * reg
            g_other = (margin > -out).to(out.dtype) * reg
        else:
            g_true = -2.0 * reg * torch.clamp(margin - out, min=0.0)
            g_other = 2.0 * reg * torch.clamp(margin + out, min=0.0)
        return (onehot * g_true + (1.0 - onehot) * g_other, None, None,
                None, None)


@register_op("SVMOutput", input_names=("data", "label"))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """The identity, as a loss layer: its backward is the one-vs-rest
    hinge gradient (L2-SVM, or L1 with ``use_linear``)."""
    return _SVMOutputFn.apply(data, label, float(margin),
                              float(regularization_coefficient),
                              bool(use_linear))


# -- normalization ------------------------------------------------------------

@register_op("BatchNorm", aliases=["BatchNorm_v1", "_contrib_SyncBatchNorm"],
             n_out=3, needs_train=True, visible_outputs=1,
             input_names=("data", "gamma", "beta", "moving_mean",
                          "moving_var"), aux_updates={1: 3, 2: 4})
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   min_calib_range=None, max_calib_range=None, ndev=1,
                   key=None, _training=False):
    """``(out, new_moving_mean, new_moving_var)`` (:func:`batch_norm`);
    the caller writes the moving statistics back."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      momentum, fix_gamma, use_global_stats, axis, _training)


def _affine(x, gamma, beta, axis):
    shape = [1] * x.dim()
    shape[axis] = -1
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register_op("LayerNorm", input_names=("data", "gamma", "beta"))
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalization over ``axis`` with ``gamma``/``beta``."""
    var, mean = torch.var_mean(data, axis, correction=0, keepdim=True)
    return _affine((data - mean) * torch.rsqrt(var + eps), gamma, beta, axis)


@register_op("GroupNorm", input_names=("data", "gamma", "beta"))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
               output_mean_var=False):
    """Normalization over groups of channels, ``gamma``/``beta`` per
    channel."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    red = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, red, correction=0, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    return _affine(x, gamma, beta, 1)


@register_op("InstanceNorm", input_names=("data", "gamma", "beta"))
def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalization over the spatial axes of each (sample, channel)."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, red, correction=0, keepdim=True)
    return _affine((data - mean) * torch.rsqrt(var + eps), gamma, beta, 1)


@register_op("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """Scale to unit L2 norm per instance, channel or spatial position."""
    red = {"instance": tuple(range(1, data.dim())), "channel": (1,)}.get(
        mode, tuple(range(2, data.dim())))
    return data / torch.sqrt(torch.sum(torch.square(data), red, keepdim=True)
                             + eps)


@register_op("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across ``nsize`` adjacent channels."""
    half = nsize // 2
    padded = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    ssum = sum(padded[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * ssum / nsize, beta)


@register_op("Dropout", needs_rng=True, needs_train=True)
def dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False,
            _training=False, _generator=None):
    """Inverted dropout (kept values scaled by ``1 / (1 - p)``), active in
    training or with ``mode="always"``; ``axes`` share one mask."""
    if (not _training and mode != "always") or p <= 0:
        return data
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    keep = 1.0 - p
    u = torch.rand(shape, generator=_generator, device=data.device)
    return data * (u < keep).to(data.dtype) / keep


@register_op("Embedding", aliases=["_contrib_SparseEmbedding"],
             input_names=("data", "weight"))
def _embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                  sparse_grad=False):
    """Rows of the table at integer indices (:func:`embedding`). On
    tensors (a graph, a block) the gradient is dense whatever
    ``sparse_grad`` says, as the JAX package's dense op gives it;
    ``nd.Embedding(..., sparse_grad=True)`` takes the sparse
    implementation in ``ndarray/sparse_ops.py``."""
    return embedding(data, weight)


# -- sequences ----------------------------------------------------------------

@register_op("SequenceMask")
def sequence_mask(data, *length, use_sequence_length=False, value=0.0,
                  axis=0):
    """Time steps past each sequence's length set to ``value``."""
    if not use_sequence_length or not length:
        return data
    ln = length[0].to(torch.int64)
    shp = [1] * data.dim()
    shp[axis] = -1
    lshp = [1] * data.dim()
    lshp[1 - axis if axis in (0, 1) else 0] = -1
    steps = torch.arange(data.shape[axis], device=data.device).reshape(shp)
    return torch.where(steps < ln.reshape(lshp), data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@register_op("SequenceLast")
def sequence_last(data, *length, use_sequence_length=False, axis=0):
    """Each sequence's last valid time step."""
    if not use_sequence_length or not length:
        return data.select(axis, -1)
    ln = (length[0].to(torch.int64) - 1).reshape(
        (1, -1) + (1,) * (data.dim() - 2))
    return torch.gather(data, axis, ln.expand(
        (1,) + tuple(data.shape[1:]))).squeeze(axis)


@register_op("SequenceReverse")
def sequence_reverse(data, *length, use_sequence_length=False, axis=0):
    """Each sequence's first ``length`` steps reversed, the padding left
    in place."""
    if not use_sequence_length or not length:
        return torch.flip(data, (axis,))
    ln = length[0].to(torch.int64)
    T = data.shape[axis]
    pos = torch.arange(T, device=data.device)[:, None]
    rev = torch.where(pos < ln[None, :], ln[None, :] - 1 - pos, pos)
    rev = rev.reshape((T, rev.shape[1]) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, rev.expand(data.shape))


@register_op("Crop")
def crop(*args, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=1):
    """Spatial crop to ``h_w`` (or the second input's size), at ``offset``
    or centred."""
    data = args[0]
    th, tw = (args[1].shape[2], args[1].shape[3]) if len(args) > 1 else h_w
    h, w = data.shape[2], data.shape[3]
    y0, x0 = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return data[:, :, y0:y0 + th, x0:x0 + tw]


for _stub in ("BilinearSampler", "GridGenerator", "SpatialTransformer",
              "ROIPooling", "_contrib_ROIAlign", "im2col", "Correlation"):
    stub_op(_stub, "the stubbed ops of ops/nn.py are the deferred half of "
            "the mx.nd slice (ROADMAP Queue A item 1)")
