"""Optimizers over torch tensors: the base class, SGD, the registry and the
updater.

Counterpart of ``mxnet_tpu/optimizer.py``'s ``Optimizer`` (per-index
update counts, ``lr``/``wd`` with their multipliers, ``rescale_grad``,
``clip_gradient``, multi-precision state), ``SGD``, ``register``/
``create`` and ``Updater``/``get_updater``. Updates write the weight and
the state in place (under ``torch.no_grad``), where the JAX package
rebinds new arrays: the state objects keep their identity, and no second
copy of a parameter is held.

Multi-precision (``multi_precision=True``) applies to **float16** weights
only, as in the JAX package: their state is ``(weight32, base_state)``,
an fp32 master copy beside the optimizer's own state; bf16 and fp32
weights take the plain update. SGD's mixed-precision momentum update is
one launch of the ``csrc/mp_sgd.cu`` kernel per parameter on CUDA, with
``lr`` and ``wd`` as launch arguments, so a learning-rate schedule
(``lr_scheduler=``, :mod:`mxnet_tpu_torch.lr_scheduler`) rebuilds nothing.
Adam, AdamW, the functional ``fused_apply`` and the aggregated
``update_multi`` are not ported yet; the per-parameter loop here computes
the same numbers as the JAX package's eager path.
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import MXNetError
from .ops import optimizer_ops as oops

__all__ = ["Optimizer", "SGD", "create", "register", "Updater",
           "get_updater"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (an instance is returned as is)."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise MXNetError(f"optimizer {name!r} is not registered (known: "
                         f"{sorted(_REGISTRY)})") from None
    return klass(**kwargs)


class Optimizer:
    """Bookkeeping shared by every optimizer: per-index update counts,
    learning rate and weight decay with per-parameter multipliers,
    ``rescale_grad`` and ``clip_gradient``, and an optional learning-rate
    schedule.

    ``param_dict`` maps an index to its parameter; a parameter's
    ``lr_mult``/``wd_mult`` attributes, where set, scale its rate and
    decay. Otherwise ``set_lr_mult``/``set_wd_mult`` give multipliers by
    index, or by name through ``param_idx2name``. With ``lr_scheduler``
    the rate is ``lr_scheduler(num_update)``, its ``base_lr`` set to
    ``learning_rate``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _mp(self, weight) -> bool:
        return self.multi_precision and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        if self._mp(weight):
            w32 = weight.detach().to(torch.float32)
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp(weight):
            w32, base_state = state
            self.update(index, w32, grad.to(torch.float32), base_state)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    # -- hyperparams ------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, by_index):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in by_index:
            return by_index[index]
        if index in self.idx2name:
            return by_index.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _common(self, index):
        """Count the update of ``index``; its ``(lr, wd, clip)``, clip
        -1 for none."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index), \
            (-1.0 if self.clip_gradient is None else self.clip_gradient)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum > 0``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd, clip = self._common(index)
        if state is None:
            weight.copy_(oops.sgd_update(weight, grad, lr=lr, wd=wd,
                                         rescale_grad=self.rescale_grad,
                                         clip_gradient=clip))
            return
        new_w, new_mom = oops.sgd_mom_update(
            weight, grad, state, lr=lr, momentum=self.momentum, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip)
        weight.copy_(new_w)
        state.copy_(new_mom)

    def update_multi_precision(self, index, weight, grad, state):
        """fp16 weights take the fused mixed-precision updates: master
        update, momentum and the fp16 cast in one pass (on CUDA, with
        momentum, one launch of the ``mp_sgd`` kernel, in place)."""
        if not self._mp(weight):
            return super().update_multi_precision(index, weight, grad, state)
        w32, mom = state
        lr, wd, clip = self._common(index)
        if mom is None:
            new_w, new_w32 = oops.mp_sgd_update(
                weight, grad, w32, lr=lr, wd=wd,
                rescale_grad=self.rescale_grad, clip_gradient=clip)
            weight.copy_(new_w)
            w32.copy_(new_w32)
            return
        oops.mp_sgd_mom_update(weight, grad, mom, w32, lr=lr,
                               momentum=self.momentum, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=clip, out=(weight, mom, w32))


class Updater:
    """Applies an optimizer to ``(index, grad, weight)``, creating each
    index's state on first sight."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, object] = {}

    @torch.no_grad()
    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
