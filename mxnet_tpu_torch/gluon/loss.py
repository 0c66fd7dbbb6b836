"""Gluon losses as blocks: the ones training needs first.

Counterpart of ``mxnet_tpu/gluon/loss.py``'s ``Loss``, ``L2Loss`` and
``SoftmaxCrossEntropyLoss``, with their weighting and batch-axis handling:
each loss is per sample, the mean over every axis but ``batch_axis``. A
loss is a ``HybridBlock``, so it takes NDArrays (and returns one) as well
as tensors. Sparse labels go through ``pick``
(:func:`mxnet_tpu_torch.ops.tensor.pick`), as in the JAX package: a label
in ``[-n, -1]`` wraps and any other out-of-range label gives a NaN loss,
on the device, where a bare gather would raise.
"""
from __future__ import annotations

import torch

from ..ops.tensor import pick
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``, mean per sample."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)`` at the label (``sparse_label``, labels are
    class indices) or summed against a dense label distribution; mean per
    sample. ``from_logits`` takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
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
