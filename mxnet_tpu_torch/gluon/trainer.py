"""Gluon Trainer: applies the optimizer in the training loop.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` on one device::

    with autograd.record():
        loss = loss_fn(model(x), y)
    autograd.backward(loss * loss_scale)
    trainer.step(batch_size * loss_scale)

``step`` sets ``rescale_grad = rescale_grad / batch_size``, reduces the
gradients (a no-op on one device) and applies the optimizer to every
parameter that requires a gradient: one list-form ``Updater`` call over
all of them where there are several (the reference's aggregated branch:
``update_multi`` in chunks for optimizers with a ``fused_apply``, and one
``mp_sgd`` launch for every fp16 parameter of multi-precision SGD with
momentum), else one call per parameter. ``save_states``/``load_states``
keep the optimizer and its states in a file (the path without a
kvstore). ``fuse_step`` makes the whole step one captured program
(:mod:`mxnet_tpu_torch.step`).

A sparse gradient (a torch sparse tensor on a parameter, as
``contrib.nn.SparseEmbedding`` leaves on its weight) goes to the
optimizer as a ``RowSparseNDArray`` and stays out of the aggregated
path: the list-form ``Updater`` updates it on its own, by the
optimizer's lazy row-wise update where it has one (else densified with
the storage-fallback warning), as the JAX package's ``_bucketable``
keeps row_sparse gradients out of its coalesced exchange
(``mxnet_tpu/gluon/trainer.py:211-217``). A Gluon parameter's gradient
is otherwise dense, ``Embedding(sparse_grad=True)``'s too, as in the JAX
package.

A gradient is consumed by the step that applies it (``.grad`` is set to
None afterwards), so a parameter that the last backward did not reach is
found: its ``.grad`` is None, which raises unless ``ignore_stale_grad`` is
set, and then it is skipped. A parameter whose ``grad_req`` attribute is
``"add"`` keeps its gradient across steps, as in the reference; the
caller zeroes it.

The Trainer takes Gluon :class:`~mxnet_tpu_torch.gluon.parameter.Parameter`s
(``net.collect_params()``, a dict or a list of them) or their tensors, and
keeps the tensors: it may be made before the first forward resolves
deferred shapes, because a deferred tensor keeps its identity when it is
made, and the optimizer makes each state at that parameter's first update.
A parameter's ``grad_req`` (``"null"``: never updated), ``lr_mult`` and
``wd_mult`` are read from it at every step.
"""
from __future__ import annotations

import time
from typing import Dict, List, Union

import torch
from torch import nn

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError
from .parameter import Parameter, row_sparse_grad

__all__ = ["Trainer"]


class Trainer:
    """``params`` is a dict (``Block.collect_params()``, or the tensors of
    :func:`collect_params`) or a list of ``Parameter``s or tensors;
    ``optimizer`` a registered name with
    ``optimizer_params``, or an :class:`~mxnet_tpu_torch.optimizer.
    Optimizer`. Only ``kvstore="device"`` (one device) is ported, so
    ``update_on_kvstore=True`` is refused too."""

    def __init__(self, params: Union[Dict[str, nn.Parameter],
                                     List[nn.Parameter]],
                 optimizer, optimizer_params=None, kvstore="device",
                 update_on_kvstore=None):
        if kvstore != "device":
            raise NotImplementedError(
                f"kvstore={kvstore!r}: the port's Trainer runs on one device "
                "(kvstore='device'); distributed kvstores come with the "
                "distribution slice (ROADMAP Queue A item 6)")
        if update_on_kvstore:
            raise MXNetError(
                "update_on_kvstore=True: the port's Trainer has no kvstore "
                "to run the optimizer on (one device); it updates in "
                "step() or in a fused step. Create the Trainer with "
                "update_on_kvstore=False (or no kvstore)")
        if isinstance(params, dict):
            names, params = list(params.keys()), list(params.values())
        elif isinstance(params, (list, tuple)):
            params = list(params)
            names = [p.name if isinstance(p, Parameter) else f"param{i}"
                     for i, p in enumerate(params)]
        else:
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        params = [p.tensor if isinstance(p, Parameter) else p
                  for p in params]
        for p in params:
            if not isinstance(p, nn.Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
        self._params = params
        self._names = names
        # the index of each parameter, by identity (a torch parameter has
        # no name of its own): what a fused step maps its parameters by
        self._param2idx = {id(p): i for i, p in enumerate(params)}
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        """The rate of the next update: the schedule's at the current
        update count, where the optimizer has one."""
        opt = self._optimizer
        return opt.lr_scheduler(opt.num_update) if opt.lr_scheduler \
            else opt.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        """Set a fixed rate; ignored where the optimizer has a schedule, as
        in the JAX package."""
        if self._optimizer.lr_scheduler is None:
            self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update every parameter, with the
        gradients rescaled by ``1 / batch_size``. Its host time goes to
        ``telemetry.record_step``."""
        t0 = time.perf_counter()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)
        telemetry.record_step(batch_size, time.perf_counter() - t0)

    def allreduce_grads(self):
        """Sum the gradients across devices: nothing to do on one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of :meth:`step`, for gradients reduced by the
        caller."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        live = []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{self._names[i]}` has not been "
                    "updated by backward since the last `step`: the "
                    "backward did not reach it. Call step(batch_size, "
                    "ignore_stale_grad=True) to skip such parameters.")
            live.append((i, p))
        updater = self._updaters[0]
        with torch.no_grad():
            grads = [row_sparse_grad(p.grad) for _, p in live]
            if len(live) > 1 and updater.aggregate_updates:
                updater([i for i, _ in live], grads,
                        [p.data for _, p in live])
            else:
                for (i, p), g in zip(live, grads):
                    updater(i, g, p.data)
            for _, p in live:
                if getattr(p, "grad_req", "write") != "add":
                    p.grad = None

    def fuse_step(self, net, loss_fn=None, shard_plan=None, **kwargs):
        """This trainer's whole step as one :class:`~mxnet_tpu_torch.step.
        StepFunction`: ``fused.step(x, y)`` replaces ``record`` ->
        ``backward`` -> ``step(batch_size)``, bit-equal to that loop for
        the optimizers with a ``fused_apply``; on CUDA one captured graph
        per input signature. The trainer keeps owning the optimizer and
        its states, which the step updates in place (``save_states`` sees
        the post-update values). A sharded plan (``shard_plan=``) waits
        for ROADMAP Queue A item 6, the elastic kvstore (which the
        constructor refuses with every other kvstore) for item 7; the
        ``MXTUNE_AUTO`` consult waits for item 8."""
        if shard_plan is not None:
            raise MXNetError("fuse_step(shard_plan=...): the sharded step "
                             "comes with the distribution slice (ROADMAP "
                             "Queue A item 6)")
        from ..step import StepFunction
        return StepFunction(net, loss_fn, trainer=self, **kwargs)

    def save_states(self, fname):
        """Write the optimizer and every state it holds to ``fname`` (the
        port's own pickle, tensors on the CPU: the JAX package's file
        pickles its own classes, and neither reads the other's)."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote: the optimizer replaces this
        Trainer's, and each state moves to its parameter's device."""
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
            updater.states = {
                i: opt_mod._to_device(s, self._params[i].device)
                for i, s in updater.states.items()}
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
