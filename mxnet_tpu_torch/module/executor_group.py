"""DataParallelExecutorGroup: one executor per context, the batch sliced
across them.

Counterpart of ``mxnet_tpu/module/executor_group.py``. Each context gets
an Executor bound (``simple_bind``, fp32 as in the JAX package) for its
slice of the batch; a loaded batch is cast to each argument's dtype and
moved to its device; ``get_params`` averages the copies.
"""
from __future__ import annotations

from typing import List

from ..base import MXNetError
from ..context import Context
from ..io.io import DataDesc
from ..ndarray.ndarray import concatenate

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice for each device, by its share of the work."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: List[Context], workload,
                 data_shapes, label_shapes, param_names, for_training,
                 inputs_need_grad, shared_group=None, logger=None,
                 fixed_param_names=None, grad_req="write", state_names=None):
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = state_names or []
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()

        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in (label_shapes or [])]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]

        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        self.execs = []
        self._bind_exec(shared_group)

    def _grad_req_for(self, name):
        if not self.for_training or name in self.fixed_param_names:
            return "null"
        if name in self.data_names:
            return "write" if self.inputs_need_grad else "null"
        if name in self.label_names or name in self.state_names:
            return "null"
        return "write"

    def _bind_exec(self, shared_group):
        self.execs = []
        for ctx, sl in zip(self.contexts, self.slices):
            nbatch = sl.stop - sl.start
            shapes = {d.name: (nbatch,) + tuple(d.shape[1:])
                      for d in self.data_shapes + self.label_shapes}
            grad_req = {n: self._grad_req_for(n) for n in self.arg_names}
            self.execs.append(self.symbol.simple_bind(
                ctx, grad_req=grad_req, **shapes))
        if shared_group is not None:
            self._share_arrays(shared_group)

    def _share_arrays(self, shared_group):
        """Bind this group's parameters, their gradients and the aux states
        to ``shared_group``'s arrays (the same NDArray objects), as a
        BucketingModule's buckets share one storage per parameter."""
        for e, s in zip(self.execs, shared_group.execs):
            for n in self.param_names:
                if n not in s.arg_dict:
                    continue
                if tuple(s.arg_dict[n].shape) != tuple(e.arg_dict[n].shape):
                    raise MXNetError(
                        f"shared parameter {n}: shape {s.arg_dict[n].shape} "
                        f"!= {e.arg_dict[n].shape}")
                e.arg_dict[n] = s.arg_dict[n]
                if n in e.grad_dict and n in s.grad_dict:
                    e.grad_dict[n] = s.grad_dict[n]
            for n in self.aux_names:
                if n in s.aux_dict:
                    e.aux_dict[n] = s.aux_dict[n]

    # -- arrays ---------------------------------------------------------------
    @property
    def param_arrays(self):
        return [[e.arg_dict[n] for e in self.execs]
                for n in self.param_names]

    @property
    def grad_arrays(self):
        return [[e.grad_dict.get(n) for e in self.execs]
                for n in self.param_names]

    @property
    def aux_arrays(self):
        return [[e.aux_dict[n] for e in self.execs] for n in self.aux_names]

    @property
    def data_arrays(self):
        return [[(sl, e.arg_dict[name]) for sl, e in
                 zip(self.slices, self.execs)] for name in self.data_names]

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Write the average of each parameter's (and aux state's) copies
        into ``arg_params`` / ``aux_params``."""
        def mean_into(dst, arrs):
            total = arrs[0]._data
            for a in arrs[1:]:
                total = total + a._data.to(total.device, total.dtype)
            if len(arrs) > 1:
                total = total / len(arrs)
            dst._data.copy_(total.detach())

        for name in self.param_names:
            mean_into(arg_params[name], [e.arg_dict[name]
                                         for e in self.execs])
        for name in self.aux_names:
            mean_into(aux_params[name], [e.aux_dict[name]
                                         for e in self.execs])

    # -- running --------------------------------------------------------------
    def _load_slice(self, batch_data, names):
        for name, full in zip(names, batch_data):
            for sl, e in zip(self.slices, self.execs):
                if name in e.arg_dict:
                    dst = e.arg_dict[name]
                    dst._data = full[sl.start:sl.stop]._data.detach().to(
                        device=dst._data.device, dtype=dst._data.dtype)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_slice(data_batch.data, self.data_names)
        if self.label_names and data_batch.label:
            self._load_slice(data_batch.label, self.label_names)
        for e in self.execs:
            e.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True for backward")
        for sl, e in zip(self.slices, self.execs):
            if out_grads is None:
                e.backward()
            else:
                e.backward([g[sl.start:sl.stop] for g in out_grads])

    def get_outputs(self, merge_multi_context=True):
        outs = [[e.outputs[i] for e in self.execs]
                for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [o[0] if len(o) == 1 else concatenate(o, axis=0)
                    for o in outs]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        grads = [[e.grad_dict.get(n) for e in self.execs]
                 for n in self.data_names]
        if merge_multi_context:
            return [g[0] if len(g) == 1 else concatenate(g, axis=0)
                    for g in grads]
        return grads

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for i, (sl, e) in enumerate(zip(self.slices, self.execs)):
            labels_slice = labels[i] if pre_sliced \
                else [lab[sl.start:sl.stop] for lab in labels]
            eval_metric.update_dict(
                dict(zip(self.label_names, labels_slice)),
                dict(zip(self.symbol.list_outputs(), e.outputs)))

    def install_monitor(self, mon):
        for e in self.execs:
            mon.install(e)
