"""The optimizer's hand-written kernel: mixed-precision SGD with momentum
over a list of tensors.

Counterpart of ``mxnet_tpu/opt/kernels.py``'s ``mp_sgd_mom_update_pallas``,
which the JAX package calls once per parameter. The kernel is
``csrc/mp_sgd.cu``: one elementwise pass over every tensor of a list,
reading the fp16 gradient, the fp32 momentum and the fp32 master weight and
writing the fp16 weight, the momentum and the master weight, 20 bytes per
element, in one launch. ``lr`` and ``wd`` (per tensor), ``momentum``,
``rescale_grad`` and ``clip_gradient`` are launch arguments, so a
learning-rate schedule never rebuilds anything.

- :func:`mp_sgd_mom_update_multi_kernel` updates a list in place with one
  launch, or one per :func:`capacity` tensors;
  :func:`mp_sgd_mom_update_kernel` is the list of one.
- On CUDA tensors each launches the kernel or raises; nothing falls back.
- On CPU tensors they compute the plain versions,
  :func:`mp_sgd_mom_update_multi_ref` (a loop of
  :func:`mp_sgd_mom_update_ref`), which is also what the kernel is held
  against on the card, bit for bit: the kernel rounds each operation on
  its own, in the plain version's order.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..base import MXNetError

__all__ = ["mp_sgd_mom_update_kernel", "mp_sgd_mom_update_ref",
           "mp_sgd_mom_update_multi_kernel", "mp_sgd_mom_update_multi_ref",
           "capacity", "LAUNCHES"]

LAUNCHES = _build.LaunchCounter("mp_sgd")

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mp_sgd_mom_update_ref(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0
                          ) -> Triple:
    """Plain version: ``(new_weight, new_mom, new_weight32)``, the formula
    of ``mp_sgd_mom_update`` in fp32 (``clip_gradient`` < 0 or None: no
    clip); ``new_weight`` in ``weight``'s dtype."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * weight32
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def mp_sgd_mom_update_multi_ref(weights, grads, moms, weights32, lrs, wds,
                                momentum=0.0, rescale_grad=1.0,
                                clip_gradient=-1.0) -> List[Triple]:
    """Plain version of the list form: :func:`mp_sgd_mom_update_ref` of
    each tensor with its own ``lr`` and ``wd``; returns the new
    ``(weight, mom, weight32)`` of each and changes nothing."""
    return [mp_sgd_mom_update_ref(w, g, m, w32, lr, momentum, wd,
                                  rescale_grad, clip_gradient)
            for w, g, m, w32, lr, wd in zip(weights, grads, moms, weights32,
                                            lrs, wds)]


def _lib():
    lib = _build.load("mp_sgd")
    fn = lib.mx_mp_sgd_mom_update_multi
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mx_mp_sgd_capacity.restype = ctypes.c_int
    return lib


def capacity() -> int:
    """The most tensors one launch takes (the kernel's table; built on
    first call)."""
    return _lib().mx_mp_sgd_capacity()


_F16, _F32 = torch.float16, torch.float32
# (position in a row of ins + outs, name, dtype): grad, mom, weight32 in;
# weight, mom, weight32 out
_ROLES = ((0, "grad", _F16), (1, "mom", _F32), (2, "weight32", _F32),
          (3, "weight", _F16), (4, "mom out", _F32),
          (5, "weight32 out", _F32))


def _check(rows, where) -> torch.device:
    """Every tensor of every row on one CUDA device, of its role's dtype,
    contiguous, as large as the row's gradient and not empty."""
    dev = rows[0][0].device
    for i, row in enumerate(rows):
        n = row[0].numel()
        if n == 0:
            raise MXNetError(f"{where}: tensor {i} is empty")
        for k, name, want in _ROLES:
            t = row[k]
            if t.dtype != want:
                raise MXNetError(f"{where}: {name} of tensor {i} is "
                                 f"{t.dtype}, the kernel takes {want}")
            if t.numel() != n:
                raise MXNetError(f"{where}: {name} of tensor {i} has "
                                 f"{t.numel()} elements, its gradient {n}")
            if not t.is_contiguous():
                raise MXNetError(f"{where}: {name} of tensor {i} is not "
                                 "contiguous")
    for i, row in enumerate(rows):
        for k, name, _ in _ROLES:
            t = row[k]
            if t.device != dev or not t.is_cuda:
                raise MXNetError(f"{where}: {name} of tensor {i} is on "
                                 f"{t.device}; the kernel takes CUDA tensors "
                                 "on one device")
    return dev


def _launch(rows, lrs, wds, momentum, rescale_grad, clip, where) -> None:
    """One launch per ``capacity()`` rows of ``(grad, mom, weight32,
    weight_out, mom_out, weight32_out)``."""
    dev = _check(rows, where)
    lib = _lib()
    cap = lib.mx_mp_sgd_capacity()
    ptrs = np.array([[t.data_ptr() for t in row] for row in rows], np.int64)
    ns = np.array([row[0].numel() for row in rows], np.int64)
    lr32 = np.asarray(lrs, np.float32)
    wd32 = np.asarray(wds, np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, len(rows), cap):
            k = min(cap, len(rows) - s)
            err = lib.mx_mp_sgd_mom_update_multi(
                k, ptrs[s:].ctypes.data, ns[s:].ctypes.data,
                lr32[s:].ctypes.data, wd32[s:].ctypes.data, float(momentum),
                float(rescale_grad), float(clip), stream)
            _build.check(lib, err, f"{where} launch")
            LAUNCHES.add()


def _clip(clip_gradient) -> float:
    return -1.0 if clip_gradient is None else float(clip_gradient)


def mp_sgd_mom_update_multi_kernel(weights: Sequence[torch.Tensor],
                                   grads: Sequence[torch.Tensor],
                                   moms: Sequence[torch.Tensor],
                                   weights32: Sequence[torch.Tensor],
                                   lrs: Sequence[float], wds: Sequence[float],
                                   momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0) -> None:
    """Update every ``(weight, mom, weight32)`` in place from its gradient
    with its own ``lr`` and ``wd``: one launch for up to :func:`capacity`
    tensors. Weights and gradients fp16, momenta and master weights fp32;
    each tensor's result is that of :func:`mp_sgd_mom_update_ref`."""
    lists = (weights, grads, moms, weights32, lrs, wds)
    if len({len(x) for x in lists}) != 1:
        raise MXNetError("mp_sgd_mom_update_multi: weights, grads, moms, "
                         "weights32, lrs and wds differ in length: "
                         f"{[len(x) for x in lists]}")
    if not weights:
        return
    clip = _clip(clip_gradient)
    if all(t.device.type == "cpu" for group in lists[:4] for t in group):
        new = mp_sgd_mom_update_multi_ref(weights, grads, moms, weights32,
                                          lrs, wds, momentum, rescale_grad,
                                          clip)
        for dst, src in zip(zip(weights, moms, weights32), new):
            for d, s in zip(dst, src):
                d.copy_(s)
        return
    rows = [(g, m, w32, w, m, w32)
            for w, g, m, w32 in zip(weights, grads, moms, weights32)]
    _launch(rows, lrs, wds, momentum, rescale_grad, clip,
            "mp_sgd_mom_update_multi")


def mp_sgd_mom_update_kernel(weight, grad, mom, weight32, lr=0.01,
                             momentum=0.0, wd=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0,
                             out: Optional[Sequence[torch.Tensor]] = None
                             ) -> Triple:
    """The fused update and cast of one tensor, the list of one:
    ``(new_weight, new_mom, new_weight32)``, the contract of
    ``mp_sgd_mom_update``. ``weight`` and ``grad`` are fp16, ``mom`` and
    ``weight32`` fp32. ``out`` names the three result tensors; passing
    ``(weight, mom, weight32)`` updates in place."""
    clip = _clip(clip_gradient)
    if out is not None and len(out) != 3:
        raise MXNetError("mp_sgd_mom_update: out is (weight, mom, weight32)")
    if all(t.device.type == "cpu" for t in (weight, grad, mom, weight32)):
        res = mp_sgd_mom_update_ref(weight, grad, mom, weight32, lr,
                                    momentum, wd, rescale_grad, clip)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return tuple(out)
    if weight.numel() != grad.numel():
        raise MXNetError(f"mp_sgd_mom_update: weight has {weight.numel()} "
                         f"elements, its gradient {grad.numel()}")
    if weight.dtype != _F16:
        raise MXNetError(f"mp_sgd_mom_update: weight is {weight.dtype}, "
                         f"the kernel takes {_F16}")
    if out is None:
        out = (torch.empty_like(weight), torch.empty_like(mom),
               torch.empty_like(weight32))
    _launch([(grad, mom, weight32, *out)], [lr], [wd], momentum,
            rescale_grad, clip, "mp_sgd_mom_update")
    return tuple(out)
