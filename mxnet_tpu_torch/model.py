"""Checkpoints and the update plumbing of the Module API, and
``FeedForward``.

Counterpart of ``mxnet_tpu/model.py``: ``save_checkpoint`` /
``load_params`` / ``load_checkpoint`` (the symbol's JSON and a ``.params``
file of ``arg:``/``aux:`` arrays, readable by either package),
``BatchEndParam``, ``_create_kvstore``, ``_update_params`` (the aggregated
chunks of ``MXNET_OPTIMIZER_AGGREGATION_SIZE`` through the list-form
``Updater``) and ``FeedForward``. There is no kvstore yet: one device, or
``kvstore=None``, trains without one, as in the JAX package; a store that
would be needed (``local``/``device`` over several devices, ``dist*``)
raises, naming ROADMAP Queue A item 6.
"""
from __future__ import annotations

import collections

from .base import MXNetError
from .context import cpu
from .ndarray import ndarray as nd_mod

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam", "FeedForward"]

_KVSTORE_WAITS = ("kvstore: the key-value stores wait with distribution "
                  "(ROADMAP Queue A item 6)")


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` where no store
    is needed (``None``, or one device and no ``dist``); else raises."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore and "elastic" not in kvstore:
        return None, False
    if not isinstance(kvstore, str):
        raise TypeError("kvstore must be KVStore, str or None")
    raise NotImplementedError(f"kvstore {kvstore!r} over {num_device} "
                              f"device(s): {_KVSTORE_WAITS}")


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater`` to each device's ``(index, grad, weight)``;
    index ``i * num_device + k`` for parameter ``i`` on device ``k``. With
    an ``aggregate_num`` above 1 the updates go in chunks of that many
    (one list call each)."""
    if kvstore:
        raise NotImplementedError(_KVSTORE_WAITS)
    updates = [[] for _ in range(num_device)]
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((i * num_device + k, g._data, w._data))
    agg = getattr(updater, "aggregate_updates", False) and \
        getattr(getattr(updater, "optimizer", None), "aggregate_num", 0) > 1
    for dev_updates in updates:
        if agg:
            width = updater.optimizer.aggregate_num
            for s in range(0, len(dev_updates), width):
                chunk = dev_updates[s:s + width]
                updater([i for i, _, _ in chunk],
                        [g for _, g, _ in chunk],
                        [w for _, _, w in chunk])
        else:
            for i, g, w in dev_updates:
                updater(i, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """``prefix-symbol.json`` and ``prefix-%04d.params`` (``arg:``/``aux:``
    names)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_mod.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch, ctx=None):
    """``(arg_params, aux_params)`` of ``prefix-%04d.params``, on ``ctx``
    (default the CPU)."""
    save_dict = nd_mod.load("%s-%04d.params" % (prefix, epoch),
                            ctx=ctx or cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint."""
    from .symbol import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """The pre-Module training API, over a Module: the constructor,
    ``fit``/``predict``/``score``/``save``/``load``/``create``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else \
            [ctx] if ctx is not None else None
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.optimizer_params = kwargs
        self._module = None

    def _build_module(self, data, label_names=None, work_load_list=None,
                      logger=None):
        from .module import Module
        import logging
        if label_names is None:
            label_names = ["softmax_label"]
        label_names = [n for n in label_names
                       if n in self.symbol.list_arguments()]
        self._module = Module(self.symbol, data_names=("data",),
                              label_names=tuple(label_names),
                              context=self.ctx, logger=logger or logging,
                              work_load_list=work_load_list)
        return self._module

    def _checkpoint_params(self):
        """The loaded parameters the symbol takes; another name raises
        unless ``allow_extra_params``."""
        if self.arg_params is None:
            return None, self.aux_params
        known = set(self.symbol.list_arguments())
        extras = set(self.arg_params) - known
        if extras and not self.allow_extra_params:
            raise MXNetError(
                f"params {sorted(extras)} are not arguments of the symbol; "
                "pass allow_extra_params=True to ignore them")
        return ({k: v for k, v in self.arg_params.items() if k in known},
                self.aux_params)

    def _ensure_predictor(self, X):
        """Bind an inference module on demand (loaded checkpoints can call
        predict/score without fit)."""
        if self._module is not None:
            return self._module
        # an unlabeled iterator still needs the symbol's label variables
        # declared as labels (not parameters); fall back to the default name
        label_names = [d[0] for d in X.provide_label] or None
        mod = self._build_module(X, label_names=label_names)
        mod.bind(data_shapes=X.provide_data,
                 label_shapes=X.provide_label or None, for_training=False)
        arg_params, aux_params = self._checkpoint_params()
        mod.set_params(arg_params or {}, aux_params or {},
                       allow_missing=False)
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train a Module on ``X`` (a DataIter, or arrays with ``y``)."""
        from .io import NDArrayIter, ResizeIter
        from .io.io import DataIter
        if not isinstance(X, DataIter):
            X = NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                            shuffle=True)
        if self.epoch_size is not None:
            X = ResizeIter(X, self.epoch_size)
        mod = self._build_module(X, label_names=[d[0]
                                                 for d in X.provide_label],
                                 work_load_list=work_load_list,
                                 logger=logger)
        arg_params, aux_params = self._checkpoint_params()
        fit_kwargs = {}
        if eval_end_callback is not None:
            fit_kwargs["eval_end_callback"] = eval_end_callback
        if eval_batch_end_callback is not None:
            fit_kwargs["eval_batch_end_callback"] = eval_batch_end_callback
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=(tuple(self.optimizer_params.items())
                                  or (("learning_rate", 0.01),)),
                initializer=self.initializer,
                arg_params=arg_params, aux_params=aux_params,
                allow_missing=arg_params is not None,
                begin_epoch=self.begin_epoch,
                num_epoch=(self.num_epoch if self.num_epoch is not None
                           else 1),
                monitor=monitor, **fit_kwargs)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Numpy outputs (a list for several); with ``return_data``, also
        the data and labels read."""
        from .io import NDArrayIter
        from .io.io import DataIter
        import numpy as _onp
        if not isinstance(X, DataIter):
            X = NDArrayIter(X, None, batch_size=self.numpy_batch_size)
        mod = self._ensure_predictor(X)
        if reset:
            X.reset()
        datas, labels = [], []
        if return_data:
            # consume once to capture data/label, then predict on the copy
            for nbatch, batch in enumerate(X):
                if num_batch is not None and nbatch == num_batch:
                    break
                pad = batch.pad or 0
                datas.append(_onp.asarray(
                    batch.data[0].asnumpy())[:batch.data[0].shape[0] - pad])
                if batch.label:
                    labels.append(_onp.asarray(batch.label[0].asnumpy())
                                  [:batch.label[0].shape[0] - pad])
            X.reset()
        outs = mod.predict(X, num_batch=num_batch, reset=False,
                           always_output_list=True)
        if len(outs) == 0:
            raise MXNetError("predict got no batches from the iterator "
                             "(exhausted iterator with reset=False?)")
        np_outs = [o.asnumpy() for o in outs]
        result = np_outs[0] if len(np_outs) == 1 else np_outs
        if return_data:
            data_cat = _onp.concatenate(datas) if datas else None
            label_cat = _onp.concatenate(labels) if labels else None
            return result, data_cat, label_cat
        return result

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """The metric over ``X``, after ``fit`` or ``load``."""
        from . import metric as metric_mod
        from .io import NDArrayIter
        from .io.io import DataIter
        if not isinstance(X, DataIter):
            raise MXNetError("score expects a DataIter with labels")
        mod = self._ensure_predictor(X)
        if isinstance(eval_metric, str):
            eval_metric = metric_mod.create(eval_metric)
        mod.score(X, eval_metric, num_batch=num_batch)
        return eval_metric.get()[1]

    def save(self, prefix, epoch=None, remove_amp_cast=True):
        """``save_checkpoint`` of the symbol and parameters."""
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {},
                        remove_amp_cast)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct and fit."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
