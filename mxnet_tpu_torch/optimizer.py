"""Optimizers over torch tensors: the base class, every optimizer of the
JAX package, the registry and the updater.

Counterpart of ``mxnet_tpu/optimizer.py``: ``Optimizer`` (per-index update
counts, ``lr``/``wd`` with their multipliers, ``rescale_grad``,
``clip_gradient``, multi-precision state, the functional ``fused_apply``
with ``fused_hyper``/``fused_signature`` and the aggregated
``update_multi``), ``SGD``, ``NAG``, ``Adam``, ``AdamW``, ``AdaGrad``,
``RMSProp``, ``AdaDelta``, ``Ftrl``, ``FTML``, ``SignSGD``, ``Signum``,
``Adamax``, ``Nadam``, ``SGLD``, ``DCASGD``, ``LBSGD``, ``Test``,
``register``/``create`` and ``Updater``/``get_updater``. Updates write the
weight and the state in place (under ``torch.no_grad``), where the JAX
package rebinds new arrays: the state objects keep their identity, and no
second copy of a parameter is held. ``fused_apply`` is pure, as there, and
``update_multi`` writes its results back.

Multi-precision (``multi_precision=True``) applies to **float16** weights
only, as in the JAX package: their state is ``(weight32, base_state)``,
an fp32 master copy beside the optimizer's own state, which the update
writes before the fp16 weight is cast from it; bf16 and fp32 weights take
the plain update. SGD's mixed-precision momentum update is the
``csrc/mp_sgd.cu`` kernel on CUDA, with ``lr`` and ``wd`` as launch
arguments, so a learning-rate schedule (``lr_scheduler=``) rebuilds
nothing. The list-form ``Updater`` call (what ``Trainer.step`` makes)
updates every fp16 SGD-with-momentum parameter of the list in **one**
launch; that is the one place the port departs from the JAX package's
per-parameter loop, and its results are bit-equal to that loop's.

Sparse (``row_sparse``) gradients and ``lazy_update`` wait for the
``mx.nd`` slice (ROADMAP Queue A item 3): a sparse gradient raises.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict

import torch

from . import config
from . import random as _random
from .base import MXNetError
from .ops import optimizer_ops as oops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "FTML", "SignSGD", "Signum", "Adamax", "Nadam",
           "SGLD", "DCASGD", "LBSGD", "Test", "create", "register",
           "Updater", "get_updater"]

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


def _dense(grad):
    """Refuse a sparse gradient: the row-wise (lazy) updates come with the
    ``mx.nd`` slice."""
    if grad.layout != torch.strided:
        raise NotImplementedError(
            "sparse (row_sparse) gradients and lazy updates are not ported "
            "yet: they come with the mx.nd slice (ROADMAP Queue A item 3)")


def _write(targets, values):
    """Copy each new value into its tensor, in place."""
    for t, v in zip(targets, values):
        t.copy_(v)


def _zeros(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


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
    ``learning_rate``. ``aggregate_num`` (flag
    ``MXNET_OPTIMIZER_AGGREGATION_SIZE``, 1-45) is the chunk of
    :meth:`update_multi`."""

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
        self.aggregate_num = max(
            1, min(45, int(config.get("MXNET_OPTIMIZER_AGGREGATION_SIZE"))))

    def __getstate__(self):
        # the parameters are the model's, not the optimizer's: a Trainer
        # that loads the optimizer sets its own (load_states)
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d

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

    def update_multi_precision_list(self, indices, weights, grads, states):
        """The list form of :meth:`update_multi_precision`: one update per
        parameter, in order (SGD updates its fp16 parameters in one
        launch)."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    # -- functional multi-tensor path --------------------------------------
    @property
    def has_fused_apply(self) -> bool:
        """True when this optimizer provides a pure :meth:`fused_apply`;
        the aggregated update needs it, and the others take the
        per-parameter loop."""
        return type(self).fused_apply is not Optimizer.fused_apply

    def fused_hyper(self, index):
        """Count the update of ``index`` and return its ``(lr, wd)``, with
        any per-step correction (Adam's bias correction) folded into
        ``lr`` by the host arithmetic of :meth:`update`, so that the
        aggregated path equals the per-parameter one bit for bit."""
        lr, wd, _ = self._common(index)
        return lr, wd

    def fused_signature(self):
        """The scalar hyperparameters :meth:`fused_apply` reads besides
        ``lrs``/``wds`` (a cache of a captured update keys on them)."""
        return (float(self.rescale_grad),
                None if self.clip_gradient is None
                else float(self.clip_gradient))

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        """Pure multi-tensor update: ``(new_weights, new_states)`` lists,
        ``states`` entries shaped as :meth:`create_state` makes them;
        nothing given is written."""
        raise NotImplementedError(
            f"{type(self).__name__} has no functional fused_apply; the "
            "aggregated update takes the per-parameter loop")

    def update_multi(self, indices, weights, grads, states):
        """Aggregated update: :meth:`fused_apply` over chunks of
        ``aggregate_num`` parameters, its results written back in place;
        the per-parameter loop where there is no ``fused_apply``."""
        if not self.has_fused_apply:
            for i, w, g, s in zip(indices, weights, grads, states):
                self.update_multi_precision(i, w, g, s)
            return
        width = max(1, self.aggregate_num)
        for start in range(0, len(indices), width):
            idxs = list(indices[start:start + width])
            ws = list(weights[start:start + width])
            ss = list(states[start:start + width])
            for g in grads[start:start + width]:
                _dense(g)
            hyper = [self.fused_hyper(i) for i in idxs]
            new_w, new_s = self.fused_apply(
                idxs, ws, list(grads[start:start + width]), ss,
                [h[0] for h in hyper], [h[1] for h in hyper])
            _write(ws, new_w)
            for s, ns in zip(ss, new_s):
                _state_write(s, ns)

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

    def _clip(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient


def _state_write(state, new_values):
    """Write :meth:`Optimizer.fused_apply`'s new state into the state's
    tensors in place (None, a tensor, or a tuple of them)."""
    if state is None:
        return
    if isinstance(state, (tuple, list)):
        for s, n in zip(state, new_values):
            _state_write(s, n)
    else:
        state.copy_(new_values)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum > 0``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        if state is None:
            weight.copy_(oops.sgd_update(weight, grad, lr=lr, wd=wd,
                                         rescale_grad=self.rescale_grad,
                                         clip_gradient=clip))
            return
        _write((weight, state), oops.sgd_mom_update(
            weight, grad, state, lr=lr, momentum=self.momentum, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip))

    def update_multi_precision(self, index, weight, grad, state):
        """fp16 weights take the fused mixed-precision updates: master
        update, momentum and the fp16 cast in one pass (on CUDA, with
        momentum, the ``mp_sgd`` kernel, in place)."""
        if not self._mp(weight):
            return super().update_multi_precision(index, weight, grad, state)
        _dense(grad)
        w32, mom = state
        lr, wd, clip = self._common(index)
        if mom is None:
            _write((weight, w32), oops.mp_sgd_update(
                weight, grad, w32, lr=lr, wd=wd,
                rescale_grad=self.rescale_grad, clip_gradient=clip))
            return
        oops.mp_sgd_mom_update(weight, grad, mom, w32, lr=lr,
                               momentum=self.momentum, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=clip, out=(weight, mom, w32))

    def update_multi_precision_list(self, indices, weights, grads, states):
        """Every fp16 parameter with momentum in one ``mp_sgd`` launch
        (``oops.mp_sgd_mom_update_multi``), the others one by one. Each
        index's update count, ``lr`` and ``wd`` are taken in list order,
        as the per-parameter loop takes them, so the results are that
        loop's, bit for bit."""
        batch = []
        for i, w, g, s in zip(indices, weights, grads, states):
            if self._mp(w) and s[1] is not None:
                _dense(g)
                lr, wd, _ = self._common(i)
                batch.append((w, g, s[1], s[0], lr, wd))
            else:
                self.update_multi_precision(i, w, g, s)
        if batch:
            cols = list(zip(*batch))
            oops.mp_sgd_mom_update_multi(
                *cols, momentum=self.momentum,
                rescale_grad=self.rescale_grad, clip_gradient=self._clip())

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        clip = self._clip()
        new_w, new_s = [], []
        for w, g, s, lr, wd in zip(weights, grads, states, lrs, wds):
            if s is None:
                new_w.append(oops.sgd_update(
                    w, g, lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                    clip_gradient=clip))
                new_s.append(None)
            else:
                nw, nm = oops.sgd_mom_update(
                    w, g, s, lr=lr, momentum=self.momentum, wd=wd,
                    rescale_grad=self.rescale_grad, clip_gradient=clip)
                new_w.append(nw)
                new_s.append(nm)
        return new_w, new_s

    def fused_signature(self):
        return super().fused_signature() + (float(self.momentum),)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (plain SGD without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        if state is None:
            weight.copy_(oops.sgd_update(weight, grad, lr=lr, wd=wd,
                                         rescale_grad=self.rescale_grad,
                                         clip_gradient=clip))
            return
        _write((weight, state), oops.nag_mom_update(
            weight, grad, state, lr=lr, momentum=self.momentum, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip))

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        clip = self._clip()
        new_w, new_s = [], []
        for w, g, s, lr, wd in zip(weights, grads, states, lrs, wds):
            if s is None:
                new_w.append(oops.sgd_update(
                    w, g, lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                    clip_gradient=clip))
                new_s.append(None)
            else:
                nw, nm = oops.nag_mom_update(
                    w, g, s, lr=lr, momentum=self.momentum, wd=wd,
                    rescale_grad=self.rescale_grad, clip_gradient=clip)
                new_w.append(nw)
                new_s.append(nm)
        return new_w, new_s

    def fused_signature(self):
        return super().fused_signature() + (float(self.momentum),)


@register
class Adam(Optimizer):
    """Adam; the bias correction is folded into ``lr`` on the host, in
    float64."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _corrected(self, index, lr):
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return lr * (math.sqrt(coef2) / coef1)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        lr = self._corrected(index, lr)
        mean, var = state
        _write((weight, mean, var), oops.adam_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip))

    def fused_hyper(self, index):
        lr, wd, _ = self._common(index)
        return self._corrected(index, lr), wd

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        clip = self._clip()
        new_w, new_s = [], []
        for w, g, s, lr, wd in zip(weights, grads, states, lrs, wds):
            mean, var = s
            nw, nm, nv = oops.adam_update(
                w, g, mean, var, lr=lr, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, wd=wd, rescale_grad=self.rescale_grad,
                clip_gradient=clip)
            new_w.append(nw)
            new_s.append((nm, nv))
        return new_w, new_s

    def fused_signature(self):
        return super().fused_signature() + (
            float(self.beta1), float(self.beta2), float(self.epsilon))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (the contrib ``_adamw_update``):
    no bias correction; ``eta`` scales the whole step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.eta = epsilon, eta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        mean, var = state
        _write((weight, mean, var), oops.adamw_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd, eta=self.eta,
            rescale_grad=self.rescale_grad, clip_gradient=clip))

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        clip = self._clip()
        new_w, new_s = [], []
        for w, g, s, lr, wd in zip(weights, grads, states, lrs, wds):
            mean, var = s
            nw, nm, nv = oops.adamw_update(
                w, g, mean, var, lr=lr, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, wd=wd, eta=self.eta,
                rescale_grad=self.rescale_grad, clip_gradient=clip)
            new_w.append(nw)
            new_s.append((nm, nv))
        return new_w, new_s

    def fused_signature(self):
        return super().fused_signature() + (
            float(self.beta1), float(self.beta2), float(self.epsilon),
            float(self.eta))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        _write((weight, state), oops.adagrad_update(
            weight, grad, state, lr=lr, epsilon=self.float_stable_eps, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip))


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Graves' form with momentum."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def _cw(self):
        return -1.0 if self.clip_weights is None else self.clip_weights

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        new_w, new_s = self.fused_apply([index], [weight], [grad], [state],
                                        [lr], [wd])
        weight.copy_(new_w[0])
        _state_write(state, new_s[0])

    def fused_apply(self, indices, weights, grads, states, lrs, wds):
        clip, cw = self._clip(), self._cw()
        new_w, new_s = [], []
        for w, g, s, lr, wd in zip(weights, grads, states, lrs, wds):
            if self.centered:
                n, g_avg, delta = s
                nw, nn, ng, nd = oops.rmspropalex_update(
                    w, g, n, g_avg, delta, lr=lr, gamma1=self.gamma1,
                    gamma2=self.gamma2, epsilon=self.epsilon, wd=wd,
                    rescale_grad=self.rescale_grad, clip_gradient=clip,
                    clip_weights=cw)
                new_w.append(nw)
                new_s.append((nn, ng, nd))
            else:
                nw, nn = oops.rmsprop_update(
                    w, g, s, lr=lr, gamma1=self.gamma1,
                    epsilon=self.epsilon, wd=wd,
                    rescale_grad=self.rescale_grad, clip_gradient=clip,
                    clip_weights=cw)
                new_w.append(nw)
                new_s.append(nn)
        return new_w, new_s

    def fused_signature(self):
        return super().fused_signature() + (
            float(self.gamma1), float(self.gamma2), float(self.epsilon),
            bool(self.centered),
            None if self.clip_weights is None else float(self.clip_weights))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        _, wd, clip = self._common(index)
        acc_g, acc_d = state
        _write((weight, acc_g, acc_d), oops.adadelta_update(
            weight, grad, acc_g, acc_d, rho=self.rho, epsilon=self.epsilon,
            wd=wd, rescale_grad=self.rescale_grad, clip_gradient=clip))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        z, n = state
        _write((weight, z, n), oops.ftrl_update(
            weight, grad, z, n, lr=lr, lamda1=self.lamda1, beta=self.beta,
            wd=wd, rescale_grad=self.rescale_grad, clip_gradient=clip))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        t = self._index_update_count[index]
        d, v, z = state
        _write((weight, d, v, z), oops.ftml_update(
            weight, grad, d, v, z, lr=lr, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, wd=wd, rescale_grad=self.rescale_grad,
            clip_grad=clip, t=t))


@register
class SignSGD(Optimizer):
    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        weight.copy_(oops.signsgd_update(weight, grad, lr=lr, wd=wd,
                                         rescale_grad=self.rescale_grad,
                                         clip_gradient=clip))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        _write((weight, state), oops.signum_update(
            weight, grad, state, lr=lr, momentum=self.momentum, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip,
            wd_lh=self.wd_lh))


@register
class Adamax(Optimizer):
    """Adam over the infinity norm; bias correction of the mean in
    ``lr``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        m, u = state
        g = grad * self.rescale_grad + wd * weight
        if clip >= 0:
            g = g.clamp(-clip, clip)
        m_new = self.beta1 * m + (1.0 - self.beta1) * g
        u_new = torch.maximum(self.beta2 * u, g.abs())
        _write((m, u), (m_new, u_new))
        weight.copy_(weight - lr * m_new / (u_new + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum; ``m_schedule`` is one product over
    every update of every index, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        t = self._index_update_count[index]
        g = grad * self.rescale_grad + wd * weight
        if clip >= 0:
            g = g.clamp(-clip, clip)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        g_prime = g / (1.0 - self.m_schedule)
        m_new = self.beta1 * m + (1.0 - self.beta1) * g
        v_new = self.beta2 * v + (1.0 - self.beta2) * g * g
        m_prime = m_new / (1.0 - m_schedule_next)
        v_prime = v_new / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        _write((m, v), (m_new, v_new))
        weight.copy_(weight - lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: half a gradient step plus
    N(0, lr) noise, drawn from the port's generator of the weight's
    device (:func:`mxnet_tpu_torch.random.generator`)."""

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        g = grad * self.rescale_grad + wd * weight
        if clip >= 0:
            g = g.clamp(-clip, clip)
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=_random.generator(weight.device))
        weight.copy_(weight - lr / 2 * g + noise * math.sqrt(lr))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, weight.detach().clone())

    def update(self, index, weight, grad, state):
        _dense(grad)
        lr, wd, clip = self._common(index)
        g = grad * self.rescale_grad
        if clip >= 0:
            g = g.clamp(-clip, clip)
        mom, prev = state
        comp = self.lamda * g * g * (weight - prev)
        if mom is not None:
            new_mom = self.momentum * mom - lr * (g + wd * weight + comp)
            mom.copy_(new_mom)
            step = new_mom
        else:
            step = -lr * (g + wd * weight + comp)
        prev.copy_(weight)
        weight.copy_(weight + step)


@register
class LBSGD(SGD):
    """Large-batch SGD; the warmup strategy is kept, the update is
    SGD's (as in the reference)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy


@register
class Test(Optimizer):
    """Mock optimizer of the tests: ``w += rescale_grad * grad`` and the
    state holds the last gradient."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        weight.copy_(weight + grad * self.rescale_grad)
        state.copy_(grad)


_REGISTRY["stochasticgradientdescent"] = SGD
_REGISTRY["adamoptimizer"] = Adam


def _to_device(state, device):
    """The state tree (None, tensors, tuples) on ``device``."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state.to(device)


class Updater:
    """Applies an optimizer to ``(index, grad, weight)``, or to lists of
    them, creating each index's state on first sight."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, object] = {}
        self.states_synced: Dict[int, bool] = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    @torch.no_grad()
    def __call__(self, index, grad, weight):
        if isinstance(index, (list, tuple)):
            for i, w in zip(index, weight):
                if i not in self.states:
                    self.states[i] = \
                        self.optimizer.create_state_multi_precision(i, w)
                    self.states_synced[i] = True
            states = [self.states[i] for i in index]
            opt = self.optimizer
            # as in the reference: the aggregated path takes plain dense
            # tensors; multi-precision lists keep their per-parameter
            # semantics (SGD runs its fp16 ones in one launch)
            if (self.aggregate_updates and opt.has_fused_apply
                    and not opt.multi_precision
                    and all(g.layout == torch.strided for g in grad)):
                opt.update_multi(list(index), list(weight), list(grad),
                                 states)
            else:
                opt.update_multi_precision_list(list(index), list(weight),
                                                list(grad), states)
            return
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Load :meth:`get_states`' bytes (or what they hold): the states,
        or ``(states, optimizer)``. Tensors come back on the CPU; a
        Trainer moves each to its parameter's device."""
        loaded = pickle.loads(states) if isinstance(states, bytes) \
            else states
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                isinstance(loaded[1], Optimizer):
            loaded, self.optimizer = loaded
            self.aggregate_updates = \
                getattr(self.optimizer, "aggregate_num", 0) > 0
        self.states = loaded
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        """The states (and, with ``dump_optimizer``, the optimizer) as
        pickle bytes, every tensor copied to the CPU. The pickle is the
        port's own: the JAX package's holds its own classes."""
        states = {i: _to_device(s, "cpu") for i, s in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
