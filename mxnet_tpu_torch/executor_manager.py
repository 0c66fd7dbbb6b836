"""The executor manager of the pre-Module training API.

Counterpart of ``mxnet_tpu/executor_manager.py``: ``_split_input_slice``,
``_load_data``/``_load_label`` (a batch's slices into each device's
arrays) and ``DataParallelExecutorManager``, over the Module's
:class:`~mxnet_tpu_torch.module.executor_group.DataParallelExecutorGroup`.
"""
from __future__ import annotations

from .module.executor_group import (DataParallelExecutorGroup,
                                    _split_input_slice)

__all__ = ["_split_input_slice", "_load_data", "_load_label",
           "DataParallelExecutorManager"]


def _load_data(batch, targets, slices):
    """Copy each slice of the batch's data into its device's array."""
    for d_src, per_dev in zip(batch.data, targets):
        for sl, dst in zip(slices, per_dev):
            dst[:] = d_src[sl.start:sl.stop]


def _load_label(batch, targets, slices):
    """Copy each slice of the batch's labels into its device's array."""
    for d_src, per_dev in zip(batch.label, targets):
        for sl, dst in zip(slices, per_dev):
            dst[:] = d_src[sl.start:sl.stop]


class DataParallelExecutorManager:
    """A group of executors, one per context, for the pre-Module
    training loop."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        self._symbol = symbol
        self._ctx = list(ctx)
        if work_load_list is None:
            work_load_list = [1.0] * len(self._ctx)
        self.arg_names = arg_names or symbol.list_arguments()
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        data_names = [d[0] for d in train_data.provide_data]
        if param_names is None:
            label_names = [l[0] for l in train_data.provide_label]
            param_names = [n for n in self.arg_names
                           if n not in data_names + label_names]
        self.param_names = param_names
        self._group = DataParallelExecutorGroup(
            symbol, self._ctx, work_load_list,
            list(train_data.provide_data), list(train_data.provide_label),
            param_names, for_training=True, inputs_need_grad=False)
        self.slices = self._group.slices

    @property
    def param_arrays(self):
        return self._group.param_arrays

    @property
    def grad_arrays(self):
        return self._group.grad_arrays

    @property
    def aux_arrays(self):
        return self._group.aux_arrays

    def install_monitor(self, monitor):
        self._group.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self._group.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self._group.get_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self._cur_batch = data_batch

    def forward(self, is_train=False):
        self._group.forward(self._cur_batch, is_train=is_train)

    def backward(self):
        self._group.backward()

    def update_metric(self, metric, labels):
        self._group.update_metric(metric, labels)
