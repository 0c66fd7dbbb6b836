"""BucketingModule: one Module per bucket key, the parameters shared.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``: each bucket's
Module is bound at its key's shapes and shares the default bucket's
arrays (``Module.bind(..., shared_module=...)``, as upstream MXNet's
executors share them): one storage per parameter, its gradient and each
aux state, so an update in any bucket is every bucket's. As upstream, a
new bucket is bound only once the parameters are initialized.
``save_checkpoint`` writes the shared parameters, one symbol file per
bucket and a JSON manifest of the keys.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._ctx = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None
        self._grad_req = None
        self._preload_params = None  # set by BucketingModule.load

    def _gen_symbol(self, key):
        sym, data_names, label_names = self._sym_gen(key)
        return sym, data_names, label_names

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._gen_symbol(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._gen_symbol(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert shared_module is None
        self._grad_req = grad_req
        if force_rebind:
            self._buckets = {}
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        sym, dnames, lnames = self._gen_symbol(self._default_bucket_key)
        module = Module(sym, dnames, lnames, logger=self.logger,
                        context=self._ctx,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._params_dirty = False
        if self._preload_params is not None:
            # checkpoint loaded before bind (BucketingModule.load):
            # install into the fresh executors, like Module's own
            # preloaded-params path
            arg_params, aux_params = self._preload_params
            module._arg_params = arg_params
            module._aux_params = aux_params
            module.params_initialized = True
            module._exec_group.set_params(arg_params, aux_params,
                                          allow_extra=True)
            self.params_initialized = True
            self._preload_params = None

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the current one, binding it at
        first sight on the default bucket's arrays."""
        assert self.binded
        if bucket_key not in self._buckets:
            assert self.params_initialized, \
                "initialize the parameters before binding another bucket"
            sym, dnames, lnames = self._gen_symbol(bucket_key)
            module = Module(sym, dnames, lnames, logger=self.logger,
                            context=self._ctx,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            compression_params=self._compression_params)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, grad_req=self._grad_req,
                        shared_module=self._buckets[self._default_bucket_key])
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            if self._curr_module.optimizer_initialized:
                module.borrow_optimizer(self._curr_module)
            self._buckets[bucket_key] = module
        else:
            module = self._buckets[bucket_key]
            if not module.optimizer_initialized and \
                    self._curr_module.optimizer_initialized:
                module.borrow_optimizer(self._curr_module)
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module and \
                    not mod.optimizer_initialized:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        # stay on the batch's bucket: the forward that follows uses it
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    @staticmethod
    def _bucket_tag(key):
        """Filename-safe rendering of a bucket key (int, str, or tuple
        like seq2seq's (enc_len, dec_len))."""
        import re
        if isinstance(key, (tuple, list)):
            raw = "_".join(str(k) for k in key)
        else:
            raw = str(key)
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def save_checkpoint(self, prefix, epoch, remove_amp_cast=False):
        """The shared parameters, one symbol JSON per bucket, and a JSON
        manifest of the bucket keys (tuple keys as lists)."""
        assert self._buckets, "empty BucketingModule cannot be saved"
        import json

        self.save_params("%s-%04d.params" % (prefix, epoch))
        tags = {}
        for key in self._buckets:
            s, _, _ = self._gen_symbol(key)
            tag = self._bucket_tag(key)
            s.save("%s-%s-symbol.json" % (prefix, tag))
            tags[tag] = list(key) if isinstance(key, (tuple, list)) \
                else key
        with open("%s-%04d.buckets.json" % (prefix, epoch), "w") as f:
            json.dump(tags, f)

    @staticmethod
    def load(prefix, epoch, sym_gen=None, default_bucket_key=None,
             **kwargs):
        """A BucketingModule from a checkpoint: the caller gives
        ``sym_gen``; the parameters go into the executors at the next
        bind. The manifest, where present, must hold the default key."""
        import json
        import os

        assert sym_gen is not None, \
            "sym_gen is required for loading BucketingModule"
        assert default_bucket_key is not None, \
            "default_bucket_key is required for loading BucketingModule"
        manifest = "%s-%04d.buckets.json" % (prefix, epoch)
        if os.path.exists(manifest):
            with open(manifest) as f:
                tags = json.load(f)
            want = BucketingModule._bucket_tag(default_bucket_key)
            if want not in tags:
                raise ValueError(
                    f"default_bucket_key {default_bucket_key!r} was not "
                    f"in the checkpoint (buckets: {sorted(tags.values())})")
        from ..model import load_params as _load_params
        mod = BucketingModule(sym_gen,
                              default_bucket_key=default_bucket_key,
                              **kwargs)
        mod._preload_params = _load_params(prefix, epoch)
        return mod

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
