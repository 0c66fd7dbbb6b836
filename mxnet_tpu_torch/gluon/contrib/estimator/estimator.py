"""``Estimator``: the train loop, its metrics and the event-handler
protocol around it.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/estimator.py``.
``fit`` runs epochs of ``record`` -> ``backward`` -> ``Trainer.step``
over ``train_data`` (batches ``(data, label)`` or ``DataBatch``es),
dispatching ``train_begin``, ``epoch_begin``, ``batch_begin``,
``batch_end``, ``epoch_end`` and ``train_end`` to the handlers that take
them; a handler stops training by returning False from ``batch_end`` or
``epoch_end``, and a :class:`StoppingHandler` for ``epochs`` always
bounds the run. The validation metrics are separate instances from the
training ones, so an evaluation during ``fit`` leaves the training
statistics alone.
"""
from __future__ import annotations

from .... import autograd
from .... import metric as metric_mod
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd)

__all__ = ["Estimator"]


class Estimator:
    """``net`` trained on ``loss`` by ``trainer`` (Adam at 1e-3 by
    default), ``train_metrics`` (Accuracy by default) updated per batch;
    ``context``, where given, is where each batch is moved."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss
        if train_metrics is None:
            train_metrics = [metric_mod.Accuracy()]
        elif not isinstance(train_metrics, (list, tuple)):
            train_metrics = [train_metrics]
        self.train_metrics = list(train_metrics)
        if val_metrics is None:
            val_metrics = [type(m)() for m in self.train_metrics]
        elif not isinstance(val_metrics, (list, tuple)):
            val_metrics = [val_metrics]
        self.val_metrics = list(val_metrics)
        self.loss_metric = metric_mod.Loss(
            name=f"train_{type(loss).__name__.lower()}_loss")
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.context = context
        self.stop_training = False

    def evaluate(self, val_data, val_metrics=None):
        """The net over ``val_data``, updating the (reset) validation
        metrics; returns their ``get()``."""
        metrics = val_metrics if val_metrics is not None \
            else self.val_metrics
        for metric in metrics:
            metric.reset()
        for batch in val_data:
            data, label = self._unpack(batch)
            pred = self.net(data)
            for metric in metrics:
                metric.update(label, pred)
        return [m.get() for m in metrics]

    def _unpack(self, batch):
        if isinstance(batch, (list, tuple)):
            data, label = batch[0], batch[1]
        else:
            data, label = batch.data[0], batch.label[0]
        if self.context is not None:
            data = data.as_in_context(self.context)
            label = label.as_in_context(self.context)
        return data, label

    def _handlers(self, event_handlers, epochs):
        handlers = list(event_handlers or [])
        handlers.append(StoppingHandler(max_epoch=epochs))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                [self.loss_metric] + self.train_metrics))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=[self.loss_metric] + self.train_metrics))
        return handlers

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_size=None):
        """Train for at most ``epochs`` epochs (see the module's
        docstring); returns self."""
        handlers = self._handlers(event_handlers, epochs)

        def dispatch(cls, method, **kwargs):
            keep_going = True
            for h in handlers:
                if isinstance(h, cls) and \
                        getattr(h, method)(self, **kwargs) is False:
                    keep_going = False
            return keep_going

        self.stop_training = False
        dispatch(TrainBegin, "train_begin")
        while not self.stop_training:
            dispatch(EpochBegin, "epoch_begin")
            for batch in train_data:
                dispatch(BatchBegin, "batch_begin", batch=batch)
                data, label = self._unpack(batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                if not dispatch(BatchEnd, "batch_end", batch=batch,
                                pred=pred, label=label, loss=loss):
                    self.stop_training = True
                    break
            if hasattr(train_data, "reset"):
                train_data.reset()
            if not dispatch(EpochEnd, "epoch_end"):
                self.stop_training = True
        dispatch(TrainEnd, "train_end")
        return self
