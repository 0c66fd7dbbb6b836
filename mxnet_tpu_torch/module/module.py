"""Module: a Symbol trained through an executor group.

Counterpart of ``mxnet_tpu/module/module.py``: ``bind``, ``init_params``
(an ``InitDesc`` with the variable's attributes per parameter),
``init_optimizer`` (``rescale_grad`` = 1 / batch size unless given),
``forward``/``backward``/``update``, ``get_params``/``set_params``,
``save_checkpoint``/``load``, ``save_optimizer_states``/
``load_optimizer_states``, ``reshape``, ``install_monitor``,
``get_input_grads``. ``context`` defaults to the current context
(``mx.gpu(0)``, which raises without CUDA); ``mx.cpu()`` is honoured.
The optimizer-state file is the port's own pickle, as
``Trainer.save_states``' is (ROADMAP, "Differences kept on purpose").
"""
from __future__ import annotations

import logging

from .. import optimizer as opt_mod
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..model import _create_kvstore, _update_params, load_checkpoint
from ..ndarray.ndarray import zeros as nd_zeros
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._context = context
        self._work_load_list = work_load_list or [1] * len(context)

        self._symbol = symbol
        data_names = list(data_names) if data_names else []
        label_names = list(label_names) if label_names is not None else []

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + list(state_names or [])
        self._param_names = [n for n in arg_names if n not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint; its parameters go into the executors
        at bind."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._symbol.save(f"{prefix}-symbol.json")
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """The outputs' shapes for the bound batch, inferred (the JAX
        package reads them off the last forward's outputs, so before the
        first forward it has none, and a SequentialModule cannot bind)."""
        assert self.binded
        shapes = {d.name: tuple(d.shape)
                  for d in self._data_shapes + self._label_shapes}
        outs = self._symbol.infer_shape_partial(**shapes)[1]
        return list(zip(self._output_names, outs))

    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind an executor per context for ``data_shapes`` /
        ``label_shapes``."""
        if force_rebind:
            if self._exec_group is not None and self._params_dirty:
                # latest weights live only in the executors; pull them
                # back before discarding or the re-bound executors get
                # stale host params and training silently regresses
                self._sync_params_from_devices()
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                              for l in (label_shapes or [])]

        shared_group = None
        if shared_module is not None:
            assert shared_module.binded and \
                shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)

        if shared_module is not None:
            # the shared module's arrays are this module's parameters
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self._arg_params is None:
            ex = self._exec_group.execs[0]
            ctx = self._context[0]
            self._arg_params = {n: nd_zeros(ex.arg_dict[n].shape, ctx,
                                            dtype=str(ex.arg_dict[n].dtype))
                                for n in self._param_names}
            self._aux_params = {n: nd_zeros(ex.aux_dict[n].shape, ctx)
                                for n in self._aux_names}
        elif self.params_initialized:
            # parameters loaded before bind (Module.load -> bind) go into
            # the fresh executors, or a loaded checkpoint would train
            # from zeros; the host copies move to the first context, as
            # bound ones are kept
            ctx = self._context[0]
            self._arg_params = {n: a.as_in_context(ctx)
                                for n, a in self._arg_params.items()}
            self._aux_params = {n: a.as_in_context(ctx)
                                for n, a in self._aux_params.items()}
            self._exec_group.set_params(self._arg_params, self._aux_params,
                                        allow_extra=True)

    # ------------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` or
        ``initializer``, then copy them into the executors."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and not (arg_params or aux_params):
            initializer = Uniform(0.01)

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    arr._data.copy_(cache_arr._data.detach())
            elif not allow_missing and cache is not None:
                raise RuntimeError(f"{name} is not presented")
            elif initializer is not None:
                initializer(InitDesc(name), arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            desc = InitDesc(name, attrs.get(name))
            if arg_params is not None or aux_params is not None:
                _impl(name, arr, arg_params)
            elif initializer is not None:
                initializer(desc, arr)
        for name, arr in sorted(self._aux_params.items()):
            if arg_params is not None or aux_params is not None:
                _impl(name, arr, aux_params)
            elif initializer is not None:
                initializer(InitDesc(name), arr)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=True)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (by name with ``optimizer_params``, or
        given) and its updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        # no kvstore yet: one that would be needed raises (item 6)
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        idx2name = {}
        for k1 in range(len(self._context)):
            idx2name.update({i * len(self._context) + k1: n for i, n in
                             enumerate(self._exec_group.param_names)})

        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s).", optimizer.rescale_grad,
                    rescale_grad)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt_mod.get_updater(optimizer)

        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on every parameter from its gradient."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=len(self._context),
                       param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())
        dev = self._context[0].torch_device
        self._updater.states = {i: opt_mod._to_device(s, dev)
                                for i, s in self._updater.states.items()}

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        # bind(force_rebind) syncs dirty params out of the old executors
        # and installs them into the fresh ones when params_initialized
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
