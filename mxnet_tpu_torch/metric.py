"""Evaluation metrics, computed on the device.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``, ``create``, and
the registered metrics (``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``Perplexity``, ``PearsonCorrelation``, ``PCC``, ``Loss``,
``CompositeEvalMetric``, ``CustomMetric``). Labels and predictions may be
NDArrays or tensors. The JAX package copies each whole prediction to the
host and counts there; here the comparison runs on the prediction's device
and ``update`` copies only the counts (a few numbers, one transfer) to the
host, so the values are the reference's while the transfer stays small.
``CustomMetric`` hands its function numpy arrays, as the reference does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "create", "register", "check_label_shapes",
           "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE", "MSE", "RMSE",
           "CrossEntropy", "NegativeLogLikelihood", "Perplexity",
           "PearsonCorrelation", "PCC", "Loss", "Torch", "Caffe",
           "CompositeEvalMetric", "CustomMetric", "np"]

_REG: Dict[str, Callable] = {}


def register(name: str):
    """Register a metric class under ``name`` (for :func:`create`)."""
    def deco(cls):
        _REG[name.lower()] = cls
        return cls
    return deco


def _t(x) -> torch.Tensor:
    """The tensor of an NDArray, tensor or array-like."""
    x = getattr(x, "_data", x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        onp.asarray(x))


def _host(*scalars) -> list:
    """Several 0-d tensors to Python numbers in one transfer."""
    return torch.stack([s.double() for s in scalars]).tolist()


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _pairs(labels, preds):
    labels, preds = check_label_shapes(labels, preds, True)
    for label, pred in zip(labels, preds):
        p = _t(pred)
        yield _t(label).to(p.device), p


class EvalMetric:
    """Base of the metrics: ``update(labels, preds)`` accumulates
    ``sum_metric`` and ``num_inst``; ``get()`` is their ratio."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _inc(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def create(metric, *args, **kwargs):
    """A metric from a name, a list of them (a composite), a metric, or a
    function ``feval(label, pred)`` (a :class:`CustomMetric`)."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    try:
        return _REG[metric.lower()](*args, **kwargs)
    except KeyError:
        raise MXNetError(f"metric {metric!r} is not registered") from None


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    """The share of predictions (argmax over ``axis``, or the values
    themselves when they have the label's rank) equal to the labels."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        correct, total = [], 0
        for label, pred in _pairs(labels, preds):
            label = label.to(torch.int32)
            if pred.dim() > label.dim():
                pred = torch.argmax(pred, self.axis)
            pred = pred.to(torch.int32)
            correct.append((label.reshape(-1) == pred.reshape(-1)).sum())
            total += label.numel()
        if correct:
            self._inc(int(_host(torch.stack(correct).sum())[0]), total)


@register("top_k_accuracy")
@register("topkaccuracy")
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` highest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label = label.to(torch.int64).reshape(-1, 1)
            k = min(self.top_k, pred.shape[-1])
            top = torch.topk(pred, k, -1).indices
            n = (top == label).any(1).sum()
            self._inc(int(_host(n)[0]), label.shape[0])


class _BinaryStats:
    """tp / fp / tn / fn of two-class predictions."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        p = torch.argmax(pred, 1)
        lab = label.to(torch.int32).reshape(p.shape)
        counts = _host(((p == 1) & (lab == 1)).sum(),
                       ((p == 1) & (lab == 0)).sum(),
                       ((p == 0) & (lab == 0)).sum(),
                       ((p == 0) & (lab == 1)).sum())
        tp, fp, tn, fn = (int(c) for c in counts)
        self.tp += tp
        self.fp += fp
        self.tn += tn
        self.fn += fn

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def f1(self):
        d = self.precision + self.recall
        return 2 * self.precision * self.recall / d if d else 0.0

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn

    @property
    def mcc(self):
        d = math.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                      * (self.tn + self.fp) * (self.tn + self.fn))
        return ((self.tp * self.tn - self.fp * self.fn) / d) if d else 0.0


class _Binary(EvalMetric):
    _stat = "f1"

    def __init__(self, name, output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self.metrics = _BinaryStats()

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            self.metrics.update(label, pred)
        self.sum_metric = getattr(self.metrics, self._stat) \
            * self.metrics.total
        self.global_sum_metric = self.sum_metric
        self.num_inst = self.metrics.total
        self.global_num_inst = self.num_inst

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset()


@register("f1")
class F1(_Binary):
    """F1 score of two-class predictions (class 1 positive)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


@register("mcc")
class MCC(_Binary):
    """Matthews correlation of two-class predictions."""

    _stat = "mcc"

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


class _Regression(EvalMetric):
    def _value(self, diff):
        raise NotImplementedError

    def update(self, labels, preds):
        vals = []
        for label, pred in _pairs(labels, preds):
            if label.shape != pred.shape:
                label = label.reshape(pred.shape)
            diff = label - pred
            if not diff.is_floating_point():
                diff = diff.double()
            vals.append(self._value(diff))
        for v in (_host(*vals) if vals else []):
            self._inc(float(v), 1)


@register("mae")
class MAE(_Regression):
    """Mean absolute error per batch, averaged over batches."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _value(self, diff):
        return diff.abs().mean()


@register("mse")
class MSE(_Regression):
    """Mean squared error per batch, averaged over batches."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _value(self, diff):
        return (diff ** 2).mean()


@register("rmse")
class RMSE(_Regression):
    """Root mean squared error per batch, averaged over batches."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _value(self, diff):
        return torch.sqrt((diff ** 2).mean())


@register("ce")
@register("crossentropy")
class CrossEntropy(EvalMetric):
    """Summed ``-log(p[label] + eps)`` per sample."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            lab = label.reshape(-1).to(torch.int64)
            prob = pred[torch.arange(lab.shape[0], device=pred.device), lab]
            ce = (-torch.log(prob + self.eps)).sum()
            self._inc(float(_host(ce)[0]), lab.shape[0])


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    """Cross-entropy under its NLL name."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register("perplexity")
class Perplexity(EvalMetric):
    """``exp`` of the mean negative log-probability of the labels, an
    ``ignore_label`` left out."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        losses, num = [], 0
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            lab = _t(label).to(pred.device).reshape(-1).to(torch.int64)
            rows = pred.reshape(-1, pred.shape[-1])
            probs = rows[torch.arange(lab.shape[0], device=rows.device), lab]
            if self.ignore_label is not None:
                ignore = lab == self.ignore_label
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                num -= int(_host(ignore.sum())[0])
            losses.append(-torch.log(torch.clamp(probs, min=1e-10)).sum())
            num += lab.shape[0]
        loss = sum(_host(*losses)) if losses else 0.0
        self._inc(float(loss), num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of labels and predictions per batch, averaged."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            r = torch.corrcoef(torch.stack([label.reshape(-1).double(),
                                            pred.reshape(-1).double()]))
            self._inc(float(_host(r[0, 1])[0]), 1)


@register("loss")
class Loss(EvalMetric):
    """The mean of the values given as predictions (a loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            p = _t(pred)
            self._inc(float(_host(p.sum())[0]), p.numel())


@register("torch")
class Torch(Loss):
    """:class:`Loss` under the reference's name for torch criterions."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register("caffe")
class Caffe(Loss):
    """:class:`Loss` under the reference's name for caffe criterions."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register("pcc")
class PCC(EvalMetric):
    """Multiclass Matthews correlation: the discrete Pearson correlation
    of the confusion matrix, grown as classes appear; NaN where it is
    undefined."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._cm = onp.zeros((0, 0), dtype=onp.float64)

    def reset(self):
        super().reset()
        self._cm = onp.zeros((0, 0), dtype=onp.float64)

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = onp.zeros((k, k), dtype=onp.float64)
            n = self._cm.shape[0]
            cm[:n, :n] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            lab = label.reshape(-1).to(torch.int64)
            cls = torch.argmax(pred, -1).reshape(-1) if pred.dim() > 1 \
                else torch.round(pred.reshape(-1)).to(torch.int64)
            keep = (lab >= 0) & (cls >= 0)
            lab, cls = lab[keep], cls[keep]
            if lab.numel() == 0:
                continue
            k = int(_host(torch.maximum(lab.max(), cls.max()))[0]) + 1
            counts = torch.bincount(lab * k + cls, minlength=k * k)
            self._grow(k)
            self._cm[:k, :k] += counts.reshape(k, k).cpu().numpy()
        c = self._cm
        n = c.sum()
        x = c.sum(axis=1)
        y = c.sum(axis=0)
        cov_xy = n * onp.trace(c) - x @ y
        denom = onp.sqrt((n * n - x @ x) * (n * n - y @ y))
        val = float(cov_xy / denom) if denom > 0 else float("nan")
        self.sum_metric = val
        self.global_sum_metric = val
        self.num_inst = 1
        self.global_num_inst = 1


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()
        super().reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


register("composite")(CompositeEvalMetric)


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            reval = self._feval(_numpy(label), _numpy(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self._inc(m, n)
            else:
                self._inc(reval, 1)


def _numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` from a function on numpy arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
