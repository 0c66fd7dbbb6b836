"""Gluon losses as blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py``'s ``Loss``, ``L2Loss``,
``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss``, ``PoissonNLLLoss`` and
``CosineEmbeddingLoss``, with their weighting (``weight``, and
``sample_weight`` broadcast against the elementwise loss) and batch-axis
handling: most losses are per sample, the mean over every axis but
``batch_axis`` (``TripletLoss`` sums there; ``PoissonNLLLoss`` returns the
mean over everything, as in the JAX package), and ``CTCLoss``
(:func:`~mxnet_tpu_torch.ops.ctc.ctc_loss`, with the JAX package's
conventions: the blank at 0, label lengths the count of labels > 0
unless given). A loss is a ``HybridBlock``, so it takes NDArrays (and
returns one) as well as tensors. Sparse labels go through ``pick``
(:func:`mxnet_tpu_torch.ops.tensor.pick`), as in the JAX package: a
label in ``[-n, -1]`` wraps and any other out-of-range label gives a NaN
loss, on the device, where a bare gather would raise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.ctc import ctc_loss
from ..ops.tensor import pick
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    if not axes:
        return loss
    return loss.mean(dim=axes)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``, mean per sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)`` at the label (``sparse_label``, labels are
    class indices) or summed against a dense label distribution; mean per
    sample. ``from_logits`` takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            loss = -pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


def _softrelu(x):
    return F.softplus(x)


class L1Loss(Loss):
    """``weight * |label - pred|``, mean per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of ``pred`` itself where
    ``from_sigmoid``) against ``label``, the positive term scaled by
    ``pos_weight`` where given; computed from logits in the stable form
    ``relu(x) - x * z + log(1 + exp(-|x|))``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities (a
    log-softmax of it unless ``from_logits``), mean per sample."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    """Smooth L1: ``|d| - rho / 2`` beyond ``rho``, ``d^2 / (2 rho)``
    within, mean per sample."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``relu(margin - pred * label)`` for labels of -1/1, mean per
    sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``, mean per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """Logistic loss of logits against labels of -1/1 (``"signed"``) or
    0/1 (``"binary"``), mean per sample."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"label_format can only be signed or binary, "
                             f"received {label_format}.")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``relu(|pred - positive|^2 - |pred - negative|^2 + margin)``, the
    squares summed per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        loss = torch.square(pred - positive.reshape(pred.shape)) - \
            torch.square(pred - negative.reshape(pred.shape))
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        loss = torch.relu(loss.sum(dim=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of ``target`` under rate
    ``exp(pred)`` (``from_logits``) or ``pred``, with Stirling's term for
    targets above 1 where ``compute_full``; the mean over everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * math.pi * (target + 1e-12))
            loss = loss + torch.where(target <= 1,
                                      torch.zeros_like(target), stirling)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``relu(cos - margin)``
    otherwise, per sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = (input1 * input2).sum(1) / (
            torch.sqrt(torch.square(input1).sum(1))
            * torch.sqrt(torch.square(input2).sum(1)) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification: ``pred`` (N, T, C) in
    ``layout="NTC"`` or (T, N, C), ``label`` (N, L) in
    ``label_layout="NT"`` or (L, N); ``pred_lengths`` and
    ``label_lengths`` are optional (N,) arrays. Returns the (N,) losses,
    weighted."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=None, params=None):
        assert layout in ("NTC", "TNC")
        assert label_layout in ("NT", "TN")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), prefix=prefix,
                         params=params)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        lengths = [t for t in (pred_lengths, label_lengths) if t is not None]
        loss = ctc_loss(pred, label, *lengths,
                        use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None)
        return _apply_weighting(loss, self._weight, sample_weight)
