"""Optimizer update ops as functions on tensors.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``,
``sgd_mom_update``, ``mp_sgd_update``, ``mp_sgd_mom_update``). Each returns
the updated tensors and leaves its inputs alone, unless ``out=`` names
tensors to write (the optimizer passes the weight and its state there to
update in place). As in the JAX package, only the mixed-precision momentum
update has a kernel: on CUDA it launches ``csrc/mp_sgd.cu``
(:mod:`mxnet_tpu_torch.opt.kernels`); the others are plain torch.
"""
from __future__ import annotations

import torch

from ..opt.kernels import mp_sgd_mom_update_kernel

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update"]


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Plain SGD step: ``w - lr * (rescaled, clipped grad + wd * w)``."""
    return weight - lr * _apply_wd(grad, weight, wd, rescale_grad,
                                   clip_gradient)


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """SGD with momentum; returns ``(new_weight, new_mom)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Mixed precision over an fp32 master weight; returns ``(new_weight,
    new_weight32)``, ``new_weight`` in ``weight``'s dtype."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


# Mixed-precision SGD with momentum over an fp32 master weight, returning
# (new_weight, new_mom, new_weight32): on CUDA the update and the cast are
# one launch of the hand-written kernel, on the CPU its plain version runs.
mp_sgd_mom_update = mp_sgd_mom_update_kernel
