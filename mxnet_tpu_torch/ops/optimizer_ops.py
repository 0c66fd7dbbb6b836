"""Optimizer update ops as functions on tensors.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py``: the SGD family
(``sgd_update``, ``sgd_mom_update``, ``mp_sgd_update``,
``mp_sgd_mom_update``, ``nag_mom_update``), ``adam_update``,
``adamw_update`` (alias ``_mp_adamw_update``), ``ftml_update``,
``ftrl_update``, ``rmsprop_update``, ``rmspropalex_update``,
``signsgd_update``, ``signum_update``, ``adagrad_update``,
``adadelta_update``, and the AMP overflow checks ``all_finite`` and
``multi_all_finite``. Each returns the updated tensors and leaves its
inputs alone, unless ``out=`` names tensors to write (the optimizer
passes the weight and its state there to update in place). As in the
JAX package, only the mixed-precision momentum update has a kernel: on
CUDA it launches ``csrc/mp_sgd.cu`` (:mod:`mxnet_tpu_torch.opt.kernels`),
and so does its list form, ``mp_sgd_mom_update_multi``; the others are
plain torch, each operation rounded on its own.

Each op is also registered for ``mx.nd`` under its MXNet name, with
MXNet's ``out=`` contract: ``nd.sgd_mom_update(w, g, mom, out=w)`` writes
the new weight into ``w`` and the new state into ``mom`` (an op's
``mutates`` map names its state inputs). On CUDA,
``nd.mp_sgd_mom_update`` of fp16 weights launches the kernel; other
dtypes, which the kernel does not take, compute the plain formula.
"""
from __future__ import annotations

import torch

from ..opt.kernels import (mp_sgd_mom_update_kernel,
                           mp_sgd_mom_update_multi_kernel,
                           mp_sgd_mom_update_ref)
from .registry import register_op

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "mp_sgd_mom_update_multi", "nag_mom_update",
           "adam_update", "adamw_update", "_mp_adamw_update", "ftml_update",
           "ftrl_update", "rmsprop_update", "rmspropalex_update",
           "signsgd_update", "signum_update", "adagrad_update",
           "adadelta_update", "all_finite", "multi_all_finite"]


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """Plain SGD step: ``w - lr * (rescaled, clipped grad + wd * w)``."""
    return weight - lr * _apply_wd(grad, weight, wd, rescale_grad,
                                   clip_gradient)


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """SGD with momentum; returns ``(new_weight, new_mom)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Mixed precision over an fp32 master weight; returns ``(new_weight,
    new_weight32)``, ``new_weight`` in ``weight``'s dtype."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


# Mixed-precision SGD with momentum over an fp32 master weight, returning
# (new_weight, new_mom, new_weight32): on CUDA the update and the cast are
# one launch of the hand-written kernel, on the CPU its plain version runs.
mp_sgd_mom_update = mp_sgd_mom_update_kernel
# The same over lists of tensors, each with its own lr and wd, in place: one
# launch on CUDA (the port's own op; the JAX package loops over parameters).
mp_sgd_mom_update_multi = mp_sgd_mom_update_multi_kernel


def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov accelerated gradient step; returns ``(new_weight,
    new_mom)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam step (bias correction is the caller's, folded into ``lr``);
    returns ``(new_weight, new_mean, new_var)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


def adamw_update(weight, grad, mean, var, rescale_grad_t=None, lr=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """AdamW step with decoupled weight decay and no bias correction (the
    contrib ``_adamw_update``); returns ``(new_weight, new_mean,
    new_var)``."""
    rs = rescale_grad_t if rescale_grad_t is not None else rescale_grad
    g = _clip(grad * rs, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                            + wd * weight)
    return new_w, new_mean, new_var


_mp_adamw_update = adamw_update


def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    """Follow-the-moving-leader step; returns ``(new_weight, d, v, z)``."""
    g = _clip(grad * rescale_grad, clip_grad) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    new_w = -new_z / d_t
    return new_w, d_t, new_v, new_z


def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal step with L1 shrinkage; returns ``(new_weight, z,
    n)``."""
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


def rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """RMSProp step (Tieleman & Hinton form); returns ``(new_weight,
    n)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


def rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.01, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp, Graves' centered form with momentum; returns
    ``(new_weight, n, g_avg, delta)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_gavg = gamma1 * g_avg + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_gavg) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_gavg, new_delta


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """signSGD step: ``w - lr * (sign(grad) + wd * w)``."""
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum step (the sign of the momentum); returns ``(new_weight,
    new_mom)``."""
    g = _clip(grad * rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad step (dense); returns ``(new_weight, new_history)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaDelta step; returns ``(new_weight, acc_g, acc_delta)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(new_acc_g + epsilon) \
        * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


def all_finite(data, init_output=True):
    """``[1.0]`` when every element of ``data`` is finite, else
    ``[0.0]`` (fp32, on ``data``'s device)."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """``[1.0]`` when every element of every array is finite, else
    ``[0.0]``: one reduction over all of them (each array's 1-norm summed
    in fp64, which an inf or a NaN anywhere makes non-finite and finite
    values cannot overflow), not one per array."""
    if not arrays:
        return torch.ones(1)
    norms = torch._foreach_norm(list(arrays), 1, dtype=torch.float64)
    return torch.isfinite(torch.stack(norms).sum()).to(
        torch.float32).reshape(1)


# -- the ops under their MXNet names, for mx.nd -------------------------------

def _mp_sgd_mom_update_op(weight, grad, mom, weight32, lr=0.01,
                          momentum=0.0, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, lazy_update=True):
    """Mixed-precision SGD with momentum: ``(new_weight, new_mom,
    new_weight32)``; fp16 weights and gradients take the kernel (one
    launch on CUDA), other dtypes the plain formula."""
    if weight.dtype == grad.dtype == torch.float16:
        return mp_sgd_mom_update_kernel(weight, grad, mom, weight32, lr,
                                        momentum, wd, rescale_grad,
                                        clip_gradient)
    return mp_sgd_mom_update_ref(weight, grad, mom, weight32, lr, momentum,
                                 wd, rescale_grad, clip_gradient)


for _name, _fn, _n, _mut, _aliases in (
        ("sgd_update", sgd_update, 1, None, None),
        ("sgd_mom_update", sgd_mom_update, 2, {1: 2}, None),
        ("mp_sgd_update", mp_sgd_update, 2, {1: 2}, None),
        ("mp_sgd_mom_update", _mp_sgd_mom_update_op, 3, {1: 2, 2: 3}, None),
        ("nag_mom_update", nag_mom_update, 2, {1: 2}, None),
        ("adam_update", adam_update, 3, {1: 2, 2: 3}, None),
        ("_adamw_update", adamw_update, 3, {1: 2, 2: 3},
         ["_mp_adamw_update"]),
        ("ftml_update", ftml_update, 4, {1: 2, 2: 3, 3: 4}, None),
        ("ftrl_update", ftrl_update, 3, {1: 2, 2: 3}, None),
        ("rmsprop_update", rmsprop_update, 2, {1: 2}, None),
        ("rmspropalex_update", rmspropalex_update, 4, {1: 2, 2: 3, 3: 4},
         None),
        ("signsgd_update", signsgd_update, 1, None, None),
        ("signum_update", signum_update, 2, {1: 2}, None),
        ("_sparse_adagrad_update", adagrad_update, 2, {1: 2},
         ["adagrad_update"]),
        ("adadelta_update", adadelta_update, 3, {1: 2, 2: 3}, None)):
    register_op(_name, n_out=_n, mutates=_mut, aliases=_aliases)(_fn)
register_op("all_finite", differentiable=False)(all_finite)
register_op("multi_all_finite", differentiable=False)(multi_all_finite)
